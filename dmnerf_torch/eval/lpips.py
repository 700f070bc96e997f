# Ported from dmnerf_tpu/eval/lpips_jax.py (the VGG16 stack on NCHW tensors, F.conv2d / max_pool2d).
"""LPIPS (VGG16 backbone) in PyTorch.

The reference scores views with the `lpips` pip package and its pretrained
VGG weights (tester.py:43,91). Here the whole LPIPS-VGG forward is written
out (conv stack, per-tap unit-normalize over channels, learned non-negative
1x1 heads, spatial mean, summed over the five taps) and the weights load from
an .npz (``--lpips_weights``) in the JAX package's layout: ``conv{i}_w``
[3,3,cin,cout] (HWIO), ``conv{i}_b`` [cout], ``lin{k}_w`` [C]. One file
serves both packages; ``python -m dmnerf_torch.tools.convert_lpips`` writes
it from the public checkpoints. Without weights load_lpips returns None and
the LPIPS column is NaN, as in the JAX package.

``normalize=False`` (the default) feeds the [0,1] images to the scaling layer
as they are, which is what the reference does (it calls lpips without
``normalize=True``); ``normalize=True`` first remaps them to [-1,1], lpips'
documented input domain.

The convolutions run on cuDNN with TF32 off (on by default for cuDNN), so the
card computes in fp32 what the CPU computes.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 feature config: out_channels per conv, "M" a 2x2 max pool; LPIPS taps
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 (0-based conv indices)
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_TAPS = (1, 3, 6, 9, 12)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def prepare_params(arrays, device="cuda") -> Dict[str, torch.Tensor]:
    """The .npz arrays as fp32 tensors on `device`, conv weights permuted
    once from HWIO to OIHW."""
    out = {}
    for k, v in arrays.items():
        t = torch.as_tensor(np.asarray(v, np.float32), device=device)
        out[k] = t.permute(3, 2, 0, 1).contiguous() if k.endswith("_w") and t.ndim == 4 else t
    return out


def _vgg_features(params, x):
    """x: [N, 3, H, W]. Returns the tapped feature maps."""
    shift = torch.as_tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    h = (x - shift) / scale
    feats = []
    ci = 0
    for item in _VGG_CFG:
        if item == "M":
            h = F.max_pool2d(h, 2, 2)            # floor mode: "VALID" windows
            continue
        h = F.relu(F.conv2d(h, params[f"conv{ci}_w"], params[f"conv{ci}_b"], padding=1))
        if ci in _TAPS:
            feats.append(h)
        ci += 1
    return feats


def _normalize(feat, eps=1e-10):
    return feat / (torch.sqrt(torch.sum(feat ** 2, dim=1, keepdim=True)) + eps)


@contextlib.contextmanager
def _cudnn_fp32():
    """cuDNN convolutions in fp32 (TF32 off) inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def lpips_distance(params, img0, img1, normalize: bool = False) -> torch.Tensor:
    """img0/img1: [H, W, 3] tensors in [0, 1] on the params' device; params
    from prepare_params. Returns the scalar LPIPS distance (0-d tensor).

    normalize=False (default) feeds the [0,1] images straight to the scaling
    layer, as the reference does; normalize=True remaps to [-1,1] first."""
    x = torch.stack([img0, img1]).to(torch.float32).permute(0, 3, 1, 2)
    if normalize:
        x = x * 2.0 - 1.0
    with _cudnn_fp32():
        feats = _vgg_features(params, x)
    total = torch.zeros((), device=x.device)
    for k, f in enumerate(feats):
        f = _normalize(f)
        d = (f[0] - f[1]) ** 2                   # [C, h, w]
        total = total + torch.mean(torch.sum(d * params[f"lin{k}_w"][:, None, None], dim=0))
    return total


def load_lpips(weights_path: Optional[str], normalize: bool = False,
               device="cuda") -> Optional[Callable]:
    """Returns lpips(img, gt) -> float on `device` (numpy [H, W, 3] images in
    [0, 1]), or None if the weights are unavailable."""
    if not weights_path or not os.path.exists(weights_path):
        return None
    device = torch.device(device)
    with np.load(weights_path) as data:
        params = prepare_params({k: data[k] for k in data.files}, device)

    def metric(img, gt):
        a = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=device)
        b = torch.as_tensor(np.asarray(gt), dtype=torch.float32, device=device)
        return float(lpips_distance(params, a, b, normalize=normalize))

    return metric


def random_weights(seed: int) -> Dict[str, np.ndarray]:
    """He-initialised VGG16 convs, small biases and uniform non-negative heads
    in the .npz layout, from a numpy seed: LPIPS weights for checks that need
    no pretrained file."""
    rng = np.random.default_rng(seed)
    out, cin, ci, taps = {}, 3, 0, []
    for item in _VGG_CFG:
        if item == "M":
            continue
        out[f"conv{ci}_w"] = rng.normal(0, np.sqrt(2.0 / (9 * cin)),
                                        (3, 3, cin, item)).astype(np.float32)
        out[f"conv{ci}_b"] = rng.normal(0, 0.01, item).astype(np.float32)
        if ci in _TAPS:
            taps.append(item)
        cin, ci = item, ci + 1
    for k, c in enumerate(taps):
        out[f"lin{k}_w"] = rng.uniform(0, 0.1, c).astype(np.float32)
    return out
