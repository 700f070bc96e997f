"""Photometric loss and PSNR (port of dmnerf_tpu/losses/photometric.py;
reference networks/evaluator.py:11,15)."""

from __future__ import annotations

import math

import torch


def img2mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)
