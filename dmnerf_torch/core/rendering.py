"""Volume rendering: alpha compositing + the coarse->fine DM-NeRF pipeline
(port of dmnerf_tpu/core/rendering.py).

- composite == reference render_train: alpha = 1-exp(-relu(sigma)*dist*|d|),
  the literal exclusive cumprod of (1 - alpha + 1e-10) as transmittance (its
  backward with no wait for the device: _CumprodNoZeros), the
  instance map composited with detached weights, passed through sigmoid, and
  the last ("air") channel dropped unless keep_air.
- render_rays == reference dm_nerf: normalise viewdirs, optional stratified
  perturb, coarse field + composite, inverse-CDF importance samples on the
  detached weights, sorted union of coarse+fine z, fine field + composite.

This is the unfused path (use_pallas=False) and the plain reference that the
fused kernels in dmnerf_torch/kernels/render_field.py are held against.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from dmnerf_torch.core.sampling import perturb_z_vals, sample_pdf


class CompositeOut(NamedTuple):
    rgb: torch.Tensor         # [R, 3]
    weights: torch.Tensor     # [R, S]
    depth: torch.Tensor       # [R]
    ins: torch.Tensor         # [R, ins_num] (sigmoid, air channel dropped)
    ins_logits: torch.Tensor  # [R, ins_num] pre-sigmoid


def sample_dists(z_vals: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Per-sample distances [R, S]: z steps, a last step of 1e10, times |d|."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    return dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)


class _CumprodNoZeros(torch.autograd.Function):
    """torch.cumprod along the last axis of an input with no zero. The
    forward is torch.cumprod; the backward is torch's own for such an input,
    the reversed cumsum of out * g over x, without torch's test of x for
    zeros, which copies a flag to the host and waits for the device."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


def alpha_weights(sigma: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """Compositing weights [R, S] from density sigma [R, S] and dists [R, S]:
    alpha times the exclusive cumprod of (1 - alpha + 1e-10). alpha lies in
    [0, 1], so no factor of the cumprod is 0."""
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = _CumprodNoZeros.apply(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1))[..., :-1]
    return alpha * trans


def composite(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
              keep_air: bool = False) -> CompositeOut:
    """Alpha-composite raw [R, S, 4+K+1] along each ray (z_vals [R, S],
    rays_d [R, 3])."""
    rgb = torch.sigmoid(raw[..., :3])
    weights = alpha_weights(raw[..., 3], sample_dists(z_vals, rays_d))

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)

    ins_logits = torch.sum(weights.detach()[..., None] * raw[..., 4:], dim=-2)
    ins_map = torch.sigmoid(ins_logits)
    if not keep_air:
        ins_map = ins_map[..., :-1]
        ins_logits = ins_logits[..., :-1]
    return CompositeOut(rgb_map, weights, depth_map, ins_map, ins_logits)


FieldFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# field_fn(pts [R,S,3], viewdirs [R,1,3]) -> raw [R,S,C]


def eval_field(field_fn: FieldFn, rays_o, rays_d, viewdirs, z_vals) -> torch.Tensor:
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return field_fn(pts, viewdirs[..., None, :])


def render_rays(coarse_fn: FieldFn, fine_fn: FieldFn,
                rays_o: torch.Tensor, rays_d: torch.Tensor,
                z_vals_coarse: torch.Tensor, n_importance: int,
                generator: Optional[torch.Generator] = None,
                perturb: bool = True,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """The coarse->fine pipeline on a ray batch; returns the reference's
    all_info dict. generator=None or perturb=False is the deterministic eval
    path (det inverse-CDF, no jitter). noise: the jitter [R, S] and the
    inverse-CDF uniforms [R, n_importance] drawn beforehand, in place of
    drawing them from generator (which then may be None)."""
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    stochastic = perturb and (generator is not None or noise is not None)
    t_rand, u = noise if noise is not None else (None, None)
    if stochastic:
        z_vals_coarse = perturb_z_vals(generator, z_vals_coarse, t_rand)

    raw_coarse = eval_field(coarse_fn, rays_o, rays_d, viewdirs, z_vals_coarse)
    rgb_c, w_c, depth_c, ins_c, ins_lg_c = composite(raw_coarse, z_vals_coarse, rays_d)

    z_mid = 0.5 * (z_vals_coarse[..., 1:] + z_vals_coarse[..., :-1])
    z_samples = sample_pdf(z_mid, w_c[..., 1:-1], n_importance,
                           generator=generator if stochastic else None,
                           det=not stochastic, u=u).detach()

    z_vals_fine, _ = torch.sort(torch.cat([z_vals_coarse, z_samples], dim=-1), dim=-1)
    raw_fine = eval_field(fine_fn, rays_o, rays_d, viewdirs, z_vals_fine)
    rgb_f, w_f, depth_f, ins_f, ins_lg_f = composite(raw_fine, z_vals_fine, rays_d)

    return {
        "rgb_fine": rgb_f, "ins_fine": ins_f, "z_vals_fine": z_vals_fine,
        "raw_fine": raw_fine, "raw_coarse": raw_coarse, "rgb_coarse": rgb_c,
        "ins_coarse": ins_c, "z_vals_coarse": z_vals_coarse,
        "depth_fine": depth_f, "depth_coarse": depth_c,
        "weights_fine": w_f,
        "ins_logits_coarse": ins_lg_c, "ins_logits_fine": ins_lg_f,
    }
