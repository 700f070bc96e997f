"""Depth sampling along rays (port of dmnerf_tpu/core/sampling.py).

- z_val_sample: linear-in-depth bins in [near, far].
- perturb_z_vals: stratified jitter within mid-point bins.
- sample_pdf: inverse-CDF sampling with searchsorted(right=True) semantics, as
  one torch.searchsorted plus gathers. The JAX package's two gather-free forms
  (mask / matmul) give bit-identical primals to this gather form.
Randomness comes from an explicit torch.Generator, or is drawn beforehand and
passed in (t_rand, u: a rank of a ray mesh takes its rows of the step's
global draws); the eval path uses neither perturb_z_vals nor the random
branch of sample_pdf.
"""

from __future__ import annotations

from typing import Optional

import torch


def z_val_sample(n_rays: int, near: float, far: float, n_samples: int,
                 device="cpu") -> torch.Tensor:
    """[n_rays, n_samples] linear-in-depth bins in [near, far]."""
    t = torch.linspace(0.0, 1.0, n_samples, device=device)
    z = near + t * (far - near)
    return z.expand(n_rays, n_samples)


def perturb_z_vals(generator: Optional[torch.Generator], z_vals: torch.Tensor,
                   t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stratified samples within bins defined by midpoints; t_rand [..., S]
    uniform in [0, 1), drawn from generator when not given."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if t_rand is None:
        t_rand = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype,
                            device=z_vals.device)
    return lower + (upper - lower) * t_rand


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               generator: Optional[torch.Generator] = None,
               det: bool = False, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of n_samples from a piecewise-constant pdf.

    bins: [..., B] bin positions (z midpoints); weights: [..., B-1] unnormalised
    pdf per interval; u: the [..., n_samples] uniforms of the random branch,
    drawn from generator when not given. Returns [..., n_samples]. Gradients
    are not stopped here; callers detach the result (reference render.py:68).
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [..., B]

    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(shape).contiguous()
    elif u is None:
        if generator is None:
            raise ValueError("sample_pdf needs a generator or u unless det=True")
        u = torch.rand(shape, generator=generator, dtype=cdf.dtype, device=cdf.device)

    B = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=B - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
