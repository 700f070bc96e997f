"""Image quality metrics: PSNR and SSIM.

Copied from dmnerf_tpu/eval/metrics.py (numpy + scipy only), unchanged but
for this docstring: the JAX package's eval/__init__.py imports its renderer,
and with it jax, so the original cannot be imported on a machine without jax.

The reference uses skimage.metrics (tester.py:89-90); skimage is not available
here, so SSIM is implemented to match skimage.structural_similarity defaults:
win_size=7 uniform filter, K1=0.01, K2=0.03, gaussian_weights=False,
multichannel -> mean over channels, with skimage's sample covariance
normalization (cov_norm = N/(N-1)).
"""

from __future__ import annotations

import numpy as np


def psnr(img: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    mse = np.mean((np.asarray(img, np.float64) - np.asarray(gt, np.float64)) ** 2)
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _uniform_filter_2d(x: np.ndarray, size: int) -> np.ndarray:
    """Mean filter with 'reflect'-free valid handling done by the caller;
    here: same-size output via cumulative sums with edge replication identical
    to scipy.ndimage.uniform_filter default ('reflect')."""
    from scipy.ndimage import uniform_filter
    return uniform_filter(x, size=size, mode="reflect")


def _ssim_single(x: np.ndarray, y: np.ndarray, data_range: float, win_size: int) -> float:
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win_size ** x.ndim
    cov_norm = NP / (NP - 1)

    ux = _uniform_filter_2d(x, win_size)
    uy = _uniform_filter_2d(y, win_size)
    uxx = _uniform_filter_2d(x * x, win_size)
    uyy = _uniform_filter_2d(y * y, win_size)
    uxy = _uniform_filter_2d(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux ** 2 + uy ** 2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    # skimage crops win_size//2 border before averaging
    pad = (win_size - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


def ssim(img: np.ndarray, gt: np.ndarray, data_range: float = 1.0,
         win_size: int = 7) -> float:
    """Multichannel SSIM (mean over channels), skimage-compatible defaults."""
    img = np.asarray(img)
    gt = np.asarray(gt)
    if img.ndim == 2:
        return _ssim_single(img, gt, data_range, win_size)
    return float(np.mean([
        _ssim_single(img[..., c], gt[..., c], data_range, win_size)
        for c in range(img.shape[-1])]))
