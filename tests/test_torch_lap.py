"""The port's host assignment (dmnerf_torch/ops/lap.py, scipy's
linear_sum_assignment) vs the JAX package's in-graph lap_square."""

import jax.numpy as jnp
import numpy as np
import pytest

from dmnerf_tpu.ops.lap import lap_square as jax_lap
from dmnerf_torch.ops.lap import lap_square


@pytest.mark.parametrize("K", [4, 32])
@pytest.mark.parametrize("drop", [0, 3, "all_but_one"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_lap_assigns_as_lap_square(K, drop, seed):
    """Costs drawn from a continuous distribution have no ties, so the
    optimum is unique: the assignment must equal lap_square's exactly,
    padding rows (>= valid) included, which take the free columns in
    ascending order."""
    valid = 1 if drop == "all_but_one" else K - drop
    cost = np.random.default_rng(seed).uniform(0.0, 3.0, (K, K)).astype(np.float32)
    cost[valid:] = 0.0                       # as ins_criterion_pair masks the rows
    got = lap_square(cost, valid)
    want = np.asarray(jax_lap(jnp.asarray(cost), valid))
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(K))


def test_host_lap_full_problem_and_bad_costs():
    cost = np.random.default_rng(5).normal(size=(6, 6))
    np.testing.assert_array_equal(lap_square(cost), np.asarray(jax_lap(jnp.asarray(cost))))
    cost[0, 0], cost[1, 2], cost[3, 3] = np.nan, np.inf, -np.inf
    col = lap_square(cost, 5)
    assert sorted(col.tolist()) == list(range(6))
    with pytest.raises(ValueError):
        lap_square(np.zeros((3, 4)))
