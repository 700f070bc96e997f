"""Photometric loss and PSNR (port of dmnerf_tpu/losses/photometric.py;
reference networks/evaluator.py:11,15).

Under a ray mesh (parallel/mesh.py) img2mse is the global mean: each rank's
mean over its equal share of the rays, over the world size, summed across
ranks (at world size 1 exactly torch.mean)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from dmnerf_torch.parallel.mesh import DataMesh, psum


def img2mse(pred: torch.Tensor, target: torch.Tensor,
            mesh: Optional[DataMesh] = None) -> torch.Tensor:
    if mesh is None:
        return torch.mean((pred - target) ** 2)
    return psum(torch.mean((pred - target) ** 2) / mesh.size, mesh)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)
