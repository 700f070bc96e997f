"""3D emptiness penalizer (port of dmnerf_tpu/losses/emptiness.py; reference
networks/penalizer.py:5-62).

- Gaussian(sigma=deta_w) weighting of |depth - sample| along the ray (metric
  distances, scaled by |rays_d|), amplitude 1/(0.4*sqrt(2pi)) + 1e-8.
- "before" region (sample < depth - tolerance): BCE of sigmoid(ins logits)
  toward one-hot(air) over all K+1 channels, weighted by (1 - gaussian),
  normalised by (K+1) * max(sum(mask), 1e-8).
- "middle" band (|sample - depth| <= tolerance): BCE of the air channel toward
  0, weighted by the gaussian, normalised by max(sum(mask), 1e-8).
- depth is detached (penalizer.py:59).

The BCE is computed in logit space (softplus), as the JAX package does, by
_BCECore: a torch.autograd.Function whose forward makes one exp(-|x|) pass
over the full-width raw [R, S, 4+K+1] (the rgb/density channels are masked,
not sliced) and whose backward rebuilds sigmoid(x) from the stored exp(-|x|)
with no transcendental.

Under a ray mesh (parallel/mesh.py) both normalisers, sum(mask_before) and
sum(mask_middle), and the BCE sum are summed across ranks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dmnerf_torch.parallel.mesh import DataMesh, psum


def _masks(x: torch.Tensor):
    """ins-channel and air-channel masks over the raw channel axis [C]."""
    c = torch.arange(x.shape[-1], device=x.device)
    return (c >= 4).to(x.dtype), (c == x.shape[-1] - 1).to(x.dtype)


class _BCECore(torch.autograd.Function):
    """Sum over [R, S, C] of the penalizer BCE on the full-width raw.
    wb [R, S]: weight of the "before" BCE toward one-hot(air) (normalisation
    folded in); wm [R, S]: weight of the "middle" BCE of the air channel
    toward 0. Using  sum_{c ins, c != air} softplus(x_c) + softplus(-x_air)
    = sum_{c ins} softplus(x_c) - x_air, the loss is
    sum softplus(x) * (ins*wb + air*wm) - x * air * wb."""

    @staticmethod
    def forward(ctx, raw, wb, wm):
        ins, air = _masks(raw)
        t = torch.exp(-torch.abs(raw))                     # the one transcendental pass
        sp = torch.relu(raw) + torch.log1p(t)               # softplus(x)
        w_all = ins * wb[..., None] + air * wm[..., None]
        ctx.save_for_backward(raw, t, wb, wm)
        return torch.sum(sp * w_all - raw * (air * wb[..., None]))

    @staticmethod
    def backward(ctx, g):
        x, t, wb, wm = ctx.saved_tensors
        ins, air = _masks(x)
        inv1pt = 1.0 / (1.0 + t)
        sig = torch.where(x >= 0, inv1pt, 1.0 - inv1pt)    # sigmoid(x)
        w_all = ins * wb[..., None] + air * wm[..., None]
        return g * (sig * w_all - air * wb[..., None]), None, None


def emptiness_penalizer(raw: torch.Tensor, z_vals: torch.Tensor, depths: torch.Tensor,
                        rays_d: torch.Tensor, tolerance: float,
                        deta_w: float, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """raw [R, S, 4+K+1]; z_vals [R, S]; depths [R, 1] (detached); rays_d [R, 3]."""
    deta_h = 0.4
    norm = torch.linalg.norm(rays_d[..., None, :], dim=-1)   # [R, 1]
    dists_before = (depths - tolerance) * norm
    dists_after = (depths + tolerance) * norm
    p_dists = z_vals * norm
    delta = depths * norm - p_dists
    gauss = (torch.exp(-(delta ** 2) / (2.0 * deta_w ** 2))
             / (deta_h * math.sqrt(2.0 * math.pi)) + 1e-8)
    mask_before = (p_dists < dists_before).to(raw.dtype)
    mask_after = (p_dists > dists_after).to(raw.dtype)
    mask_middle = 1.0 - (mask_after + mask_before)
    n_ch = raw.shape[-1] - 4                                   # K+1 instance channels
    wb = (1.0 - gauss) * mask_before / (
        n_ch * torch.clamp(psum(mask_before.sum(), mesh), min=1e-8))
    wm = gauss * mask_middle / torch.clamp(psum(mask_middle.sum(), mesh), min=1e-8)
    return psum(_BCECore.apply(raw, wb.detach(), wm.detach()), mesh)


def ins_penalizer(raw: torch.Tensor, z_vals: torch.Tensor, depth: torch.Tensor,
                  rays_d: torch.Tensor, tolerance: float, deta_w: float,
                  mesh: Optional[DataMesh] = None) -> torch.Tensor:
    return emptiness_penalizer(raw, z_vals, depth.detach()[..., None], rays_d,
                               tolerance, deta_w, mesh)
