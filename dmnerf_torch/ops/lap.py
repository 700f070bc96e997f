"""Linear assignment for the matched instance loss (port of
dmnerf_tpu/ops/lap.py::lap_square).

The JAX package solves the [K, K] problem inside the jitted step; here it is
solved on the host by scipy.optimize.linear_sum_assignment, the reference's
own choice (networks/evaluator.py:43-52). That costs the train step one
device->host copy of the costs per step (the coarse and fine problems share
it).

`lap_square`'s contract is kept: rows >= n_valid are indifferent padding,
their costs are ignored, and they take the columns the valid rows leave free,
in ascending order. On costs without ties the assignment is lap_square's.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def lap_square(cost: np.ndarray, n_valid=None) -> np.ndarray:
    """Min-cost assignment on an [n, n] cost matrix; returns col4row int64 [n].

    n_valid: rows >= n_valid are padding, assigned to the columns the first
    n_valid rows leave free (ascending). NaN/Inf costs are sanitised as
    lap_square does (NaN -> 0, +-Inf -> +-5e29)."""
    cost = np.asarray(cost, dtype=np.float64)
    n = cost.shape[0]
    if cost.shape != (n, n):
        raise ValueError(f"lap_square: expected a square cost, got {cost.shape}")
    nv = n if n_valid is None else int(min(max(int(n_valid), 0), n))
    cost = np.nan_to_num(cost, nan=0.0, posinf=5e29, neginf=-5e29)
    rows, cols = linear_sum_assignment(cost[:nv])
    col4row = np.empty(n, np.int64)
    col4row[rows] = cols
    free = np.setdiff1d(np.arange(n), cols)          # ascending
    col4row[nv:] = free[:n - nv]
    return col4row
