# Copied from dmnerf_tpu/edit/deform.py.
"""Deformation ray helpers: per-pixel-row ray-origin shifts.

Behavior parity with the reference's networks/manipulator.py:397-429: the demo's
'deform' mode shifts tar ray origins along x by a per-row curve
(sin / e^x / linear / abs_linear / ln); the sin curve is additionally scaled by
a per-view oscillation deform_v (:381-382). Row constants are the reference's
hardcoded values (tuned for 400-row DM-SR images).
"""

from __future__ import annotations

import numpy as np

DEFORM_V = np.concatenate([np.linspace(0, 0.18, 2), np.linspace(0.18, 0, 2),
                           np.linspace(0, -0.18, 2), np.linspace(-0.18, 0, 2)])


def deform_curve(deform_func: str, H: int, W: int) -> np.ndarray:
    """View-independent per-pixel x-offset curve, flattened [H*W].

    The full offset is curve * deform_scale(deform_func, view_idx) — only the
    sin curve has a per-view oscillation (manipulator.py:381-382); splitting
    the static curve from the scalar lets the pose-based edit dispatch keep
    the [H*W] curve as a compiled-in constant and ship one f32 per view."""
    v = np.linspace(1, H, H)
    if deform_func == "sin":
        v = np.sin(((8 * np.pi) / 400) * v)
    elif deform_func == "ex":
        v = np.exp(-v / 50)
    elif deform_func == "linear":
        v = (v - 200) / 215
    elif deform_func == "abs_linear":
        v = np.abs(v - 200) / 200
    elif deform_func == "ln":
        v = np.log(v / 200)
    else:
        raise ValueError(f"unknown deform_func {deform_func!r}")
    return np.repeat(v[:, None], W, axis=-1).reshape(-1)


def deform_scale(deform_func: str, view_idx: int = 0) -> float:
    """Per-view scalar multiplier on deform_curve (1.0 except sin)."""
    if deform_func == "sin":
        return float(DEFORM_V[view_idx % len(DEFORM_V)])
    return 1.0


def deform_offsets(deform_func: str, H: int, W: int, view_idx: int = 0) -> np.ndarray:
    """Per-pixel x-offsets, flattened [H*W]."""
    return deform_curve(deform_func, H, W) * deform_scale(deform_func, view_idx)


def deform_rays(rays_o: np.ndarray, rays_d: np.ndarray, deform_func: str,
                H: int, W: int, view_idx: int = 0):
    """rays_o/rays_d: [H*W, 3] -> deformed (rays_o, rays_d)."""
    off = deform_offsets(deform_func, H, W, view_idx)
    out_o = rays_o.copy()
    out_o[:, 0] = out_o[:, 0] + off
    return out_o, rays_d
