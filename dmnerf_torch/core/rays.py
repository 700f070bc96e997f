"""Ray generation from camera intrinsics + pose (port of dmnerf_tpu/core/rays.py).

The intrinsics-matrix form of the reference (get_rays_k); camera-convention
sign differences live in each dataset's K.
"""

from __future__ import annotations

import torch


def pixel_grid(H: int, W: int, dtype=torch.float32, device="cpu"):
    """(i, j) pixel coordinates with i = column (x), j = row (y), each [H, W]."""
    j, i = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device), indexing="ij")
    return i, j


def ray_dirs_cam(i: torch.Tensor, j: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-frame ray directions [(i - cx)/fx, (j - cy)/fy, K22], any shape."""
    return torch.stack([
        (i - K[0, 2]) / K[0, 0],
        (j - K[1, 2]) / K[1, 1],
        K[2, 2] * torch.ones_like(i),
    ], dim=-1)


def get_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor):
    """Full-image rays on K's device. Returns (rays_o, rays_d), each [H, W, 3]."""
    i, j = pixel_grid(H, W, device=K.device)
    dirs = ray_dirs_cam(i, j, K)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def rays_at_pixels(pix_idx: torch.Tensor, W: int, K: torch.Tensor, c2w: torch.Tensor):
    """Rays for flat row-major pixel indices pix_idx [N] -> (rays_o, rays_d) [N, 3]."""
    pix_idx = pix_idx.to(torch.int64)
    j = torch.div(pix_idx, W, rounding_mode="floor").to(torch.float32)  # row
    i = (pix_idx % W).to(torch.float32)                                   # col
    dirs = ray_dirs_cam(i, j, K)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d
