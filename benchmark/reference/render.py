"""Volume rendering of DM-NeRF in plain float32 PyTorch: rays from a
pinhole camera, stratified depths, alpha compositing, inverse-CDF importance
sampling and the coarse-to-fine pass; and the test-view render (label and
confidence from the composited instance map).

- alpha = 1 - exp(-relu(sigma) * dist * |d|), the last dist 1e10; the
  transmittance is the exclusive product of (1 - alpha + 1e-10).
- the instance map is composited with the weights' gradient stopped, passed
  through a sigmoid, and its last ("air") channel dropped.
- importance samples: pdf = (w[1:-1] + 1e-5) normalised over the mid-points of
  the coarse depths; u evenly spaced in [0, 1] at test time, uniform draws in
  training; the first cdf entry above u (searchsorted right) sets the bin.
"""

from __future__ import annotations

import torch

from benchmark.reference.field import density, field


def pixel_dirs(i: torch.Tensor, j: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-frame directions of pixel columns i and rows j."""
    return torch.stack([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
                        K[2, 2] * torch.ones_like(i)], dim=-1)


def view_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor):
    """(rays_o, rays_d) [H*W, 3] of a whole view, row-major."""
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=K.device),
                          torch.arange(W, dtype=torch.float32, device=K.device), indexing="ij")
    d = (pixel_dirs(i, j, K) @ c2w[:3, :3].T).reshape(-1, 3)
    return c2w[:3, 3].expand(d.shape), d


def linear_depths(n_rays: int, near: float, far: float, n: int, device) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, n, device=device)
    return (near + t * (far - near)).expand(n_rays, n)


def weights_of(sigma: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    dists = z[:, 1:] - z[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1)[:, None]
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    ones = torch.ones_like(alpha[:, :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1), dim=-1)[:, :-1]
    return alpha * trans


def importance(z: torch.Tensor, w: torch.Tensor, n: int, u=None) -> torch.Tensor:
    """n depths per ray drawn from the coarse weights w (no gradient); u the
    [R, n] uniforms, or None for evenly spaced ones."""
    with torch.no_grad():
        bins = 0.5 * (z[:, 1:] + z[:, :-1])
        pdf = w[:, 1:-1] + 1e-5
        pdf = pdf / pdf.sum(-1, keepdim=True)
        cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], dim=-1)
        if u is None:
            u = torch.linspace(0.0, 1.0, n, device=z.device).expand(z.shape[0], n).contiguous()
        idx = torch.searchsorted(cdf.contiguous(), u, right=True)
        below = torch.clamp(idx - 1, min=0)
        above = torch.clamp(idx, max=cdf.shape[-1] - 1)
        c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
        b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
        den = c1 - c0
        den = torch.where(den < 1e-5, torch.ones_like(den), den)
        return b0 + (u - c0) / den * (b1 - b0)


def composite(raw: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor) -> dict:
    w = weights_of(raw[..., 3], z, rays_d)
    logits = torch.sum(w.detach()[..., None] * raw[..., 4:], dim=-2)
    return {"rgb": torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), dim=-2),
            "depth": torch.sum(w * z, dim=-1), "weights": w,
            "ins": torch.sigmoid(logits)[:, :-1], "logits": logits[:, :-1]}


def run_field(w: dict, cfg: dict, rays_o, rays_d, z, quantize=None) -> torch.Tensor:
    """raw [R, S, C] of the field at the depths z [R, S] along the rays."""
    R, S = z.shape
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    vd = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    vd = vd[:, None, :].expand(R, S, 3).reshape(-1, 3)
    return field(w, cfg, pts, vd, quantize).reshape(R, S, -1)


@torch.no_grad()
def render_view(w_coarse: dict, w_fine: dict, cfg: dict, K: torch.Tensor, c2w: torch.Tensor,
                block: int = 8192, quantize=None) -> dict:
    """A test view: rgb [H*W, 3], depth [H*W], ins [H*W, ins_num] (sigmoid),
    label [H*W] (argmax of ins), conf [H*W] (its max) and acc [H*W] (the
    fine pass's opacity, the sum of its weights), in blocks of rays."""
    H, W = int(cfg["H"]), int(cfg["W"])
    near, far = float(cfg["near"]), float(cfg["far"])
    n_s, n_i = int(cfg["N_samples"]), int(cfg["N_importance"])
    rays_o, rays_d = view_rays(H, W, K, c2w)
    outs = []
    for s in range(0, rays_o.shape[0], block):
        ro, rd = rays_o[s:s + block], rays_d[s:s + block]
        z = linear_depths(ro.shape[0], near, far, n_s, ro.device)
        pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
        sigma = density(w_coarse, cfg, pts, quantize).reshape(z.shape)
        z_f, _ = torch.sort(torch.cat([z, importance(z, weights_of(sigma, z, rd), n_i)], -1), -1)
        c = composite(run_field(w_fine, cfg, ro, rd, z_f, quantize), z_f, rd)
        outs.append((c["rgb"], c["depth"], c["ins"], c["weights"].sum(-1)))
    rgb, depth, ins, acc = (torch.cat(x) for x in zip(*outs))
    conf, label = torch.max(ins, dim=-1)
    return {"rgb": rgb, "depth": depth, "ins": ins, "label": label, "conf": conf, "acc": acc}
