"""Sinusoidal positional encoding (port of dmnerf_tpu/core/encoding.py).

Reference channel order: [x, sin(f0*x), cos(f0*x), sin(f1*x), cos(f1*x), ...]
with 3 channels per block and log-spaced frequencies f_i = 2^i. The JAX
package's grouped variant (positional_encoding_grouped) existed to avoid an
XLA layout cost on the TPU and has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch


def encoding_dim(multires: int, input_dims: int = 3, include_input: bool = True) -> int:
    if multires <= 0:  # identity embedding (i_embed == -1)
        return input_dims
    return input_dims * (int(include_input) + 2 * multires)


def freq_bands(multires: int) -> np.ndarray:
    """2^linspace(0, multires-1, multires) — log-sampled frequency bands."""
    return 2.0 ** np.linspace(0.0, multires - 1, multires)


def positional_encoding(x: torch.Tensor, multires: int,
                        include_input: bool = True) -> torch.Tensor:
    """x: [..., D] -> [..., D*(1+2*multires)] in x's dtype.

    The band multiplications are exact (powers of two), so the values equal
    the JAX package's bit for bit up to the sin/cos implementation."""
    if multires <= 0:
        return x
    bands = torch.as_tensor(freq_bands(multires), dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * bands[:, None]                  # [..., F, D]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # [..., F, 2, D]
    enc = sc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
