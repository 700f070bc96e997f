# Ported from dmnerf_tpu/data/procedural.py (the march in torch on a device; make_objects, _hsv, edited_objects and palette are copies).
"""Parameterized analytic scenes for reference-format stress fixtures.

Generalizes data/synthetic.py to N objects (boxes + spheres) with arbitrary
per-object affine transforms, so dmnerf_torch/tools/make_stress_scenes.py can
write harder scenes TO DISK in the reference dataset formats (DM-SR /
Replica / ScanNet) and render exact manipulation ground truth (the edited
scene is just the same object list with one object's inverse transform
changed).

The scene description is host-side numpy; render_gt marches dense samples
with the same compositing math as the renderer (render.py:6-28 semantics)
in torch on an explicit device, in chunks of whole rows of at most
CHUNK_POINTS samples (a 640x480 view at 192 samples is 8 chunks). The ray
directions and their norms are computed on the host exactly as the JAX
package computes them; everything after runs on the device. render_gt
returns numpy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

# samples per row chunk of render_gt: ~100 MB of points in float32, a few
# hundred MB of per-object temporaries
CHUNK_POINTS = 1 << 23


def _like(a, pts: torch.Tensor) -> torch.Tensor:
    """A host array as a tensor of pts' dtype on pts' device."""
    return torch.as_tensor(np.asarray(a), dtype=pts.dtype, device=pts.device)


def _affine(pts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """pts @ x[:3, :3].T + x[:3, 3], each product summed in a fixed order on
    every device."""
    p0, p1, p2 = pts[..., 0:1], pts[..., 1:2], pts[..., 2:3]
    return p0 * x[:3, 0] + p1 * x[:3, 1] + p2 * x[:3, 2] + x[:3, 3]


@dataclasses.dataclass
class Obj:
    kind: str                 # 'box' | 'sphere'
    center: np.ndarray        # [3]
    size: np.ndarray          # [3] half-extents (box) or [r, _, _] (sphere)
    color: np.ndarray         # [3] in [0, 1]
    label: int
    # points are mapped through xform BEFORE the occupancy test: moving an
    # object by T means setting xform = T^-1 is NOT needed — the manipulator
    # convention (tar rays = T @ pose, manipulator.py:239) shows the object
    # where p satisfies T(p) in original region, i.e. xform = T.
    xform: Optional[np.ndarray] = None  # [4, 4] or None

    def occupancy(self, pts: torch.Tensor) -> torch.Tensor:
        q = pts if self.xform is None else _affine(pts, _like(self.xform, pts))
        if self.kind == "box":
            return ((q - _like(self.center, pts)).abs() < _like(self.size, pts)).all(-1)
        d = q - _like(self.center, pts)
        return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2] \
            < float(self.size[0]) ** 2


ROOM_HALF = np.array([6.0, 6.0, 6.0])
ROOM_COLOR = np.array([0.72, 0.72, 0.76])
WALL_THICK = 0.4
DENSITY = 60.0


def make_objects(n: int, seed: int = 0, room_half=ROOM_HALF) -> List[Obj]:
    """n distinct objects (labels 1..n; label 0 = room) placed on a jittered
    ring + inner grid inside the room so most are visible from orbit cameras."""
    rng = np.random.default_rng(seed)
    objs = []
    golden = np.pi * (3 - np.sqrt(5))
    for i in range(n):
        ang = i * golden
        rad = 1.2 + 3.2 * ((i % 4) / 3.0)            # four rings
        c = np.array([rad * np.cos(ang), rad * np.sin(ang),
                      rng.uniform(-0.8, 1.4)])
        kind = "box" if i % 3 else "sphere"
        if kind == "box":
            size = rng.uniform(0.35, 0.75, 3)
        else:
            size = np.array([rng.uniform(0.35, 0.65)] * 3)
        # distinct, saturated colors (golden-angle hue walk)
        h = (i * 0.381966) % 1.0
        col = _hsv(h, 0.75, 0.55 + 0.4 * ((i % 2)))
        objs.append(Obj(kind, c, size, col, label=i + 1))
    return objs


def _hsv(h, s, v):
    i = int(h * 6) % 6
    f = h * 6 - int(h * 6)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    return np.array([(v, t, p), (q, v, p), (p, v, t),
                     (p, q, v), (t, p, v), (v, p, q)][i])


def field_at(pts: torch.Tensor, objs: List[Obj]):
    """Analytic (sigma, rgb, label) at [..., 3] points. Label 0 = room shell;
    later objects overwrite earlier ones where they overlap."""
    sh = pts.shape[:-1]
    sigma = torch.zeros(sh, dtype=torch.float32, device=pts.device)
    rgb = torch.zeros(sh + (3,), dtype=torch.float32, device=pts.device)
    label = torch.zeros(sh, dtype=torch.int32, device=pts.device)

    d = pts.abs() - _like(ROOM_HALF, pts)
    near_wall = (d < 0).all(-1) & (d.amax(-1) > -WALL_THICK)
    sigma.masked_fill_(near_wall, DENSITY)
    rgb = torch.where(near_wall[..., None], _like(ROOM_COLOR, pts), rgb)

    for o in objs:
        inside = o.occupancy(pts)
        sigma.masked_fill_(inside, DENSITY)
        rgb = torch.where(inside[..., None], _like(o.color, pts), rgb)
        label.masked_fill_(inside, o.label)
    return sigma, rgb, label


def _march_chunk(rays_o, rays_d, norm, z, dists0, objs):
    """One row-chunk of dense marching: rays [rows, W, 3], their norms
    [rows, W], samples z [S] -> (image [rows, W, 3], labels [rows, W])."""
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[:, None]
    sigma, rgb, lab = field_at(pts, objs)
    dists = dists0 * norm[..., None]
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    w = alpha * trans
    img = (w[..., None] * rgb).sum(-2)
    top = torch.argmax(w, dim=-1)
    lab_img = torch.take_along_dim(lab, top[..., None], -1)[..., 0]
    return img, lab_img


def render_gt(pose, H, W, K, near, far, objs, n_samples=192, *, device):
    """Dense-march GT (image f32 [H,W,3], labels int32 [H,W], numpy), in
    chunks of whole rows of at most CHUNK_POINTS samples on `device`."""
    device = torch.device(device)
    pose34 = np.asarray(pose, np.float32)[:3, :4]
    Kr = np.asarray(K, np.float32)
    z = np.linspace(near, far, n_samples, dtype=np.float32)
    dists0 = np.append(np.diff(z), np.float32(1e10)).astype(np.float32)
    z_d, dists0_d = (torch.from_numpy(a).to(device) for a in (z, dists0))
    rows = max(1, CHUNK_POINTS // (W * n_samples))

    imgs, labs = [], []
    for r0 in range(0, H, rows):
        j, i = np.meshgrid(np.arange(r0, min(r0 + rows, H), dtype=np.float32),
                           np.arange(W, dtype=np.float32), indexing="ij")
        dirs = np.stack([(i - Kr[0, 2]) / Kr[0, 0], (j - Kr[1, 2]) / Kr[1, 1],
                         Kr[2, 2] * np.ones_like(i)], -1)
        rays_d = (dirs @ pose34[:3, :3].T).astype(np.float32)
        norm = np.linalg.norm(rays_d, axis=-1)
        rays_o = np.broadcast_to(pose34[:3, 3], rays_d.shape)
        img, lab_img = _march_chunk(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                      for a in (rays_o, rays_d, norm)),
                                    z_d, dists0_d, objs)
        imgs.append(img.cpu().numpy())
        labs.append(lab_img.cpu().numpy())
    return np.concatenate(imgs, 0), np.concatenate(labs, 0).astype(np.int32)


def edited_objects(objs: List[Obj], move_label: int, T: np.ndarray) -> List[Obj]:
    """Scene with the object of `move_label` moved per the manipulator
    convention: querying along rays transformed by T shows the object where
    T(p) hits its original region — exactly Obj.xform = T composed with any
    existing xform."""
    out = []
    for o in objs:
        if o.label == move_label:
            x = T if o.xform is None else o.xform @ T
            out.append(dataclasses.replace(o, xform=np.asarray(x, np.float64)))
        else:
            out.append(o)
    return out


def palette(n_labels: int, seed: int = 1) -> np.ndarray:
    """uint8 [n_labels, 3] distinct colors (label 0 = room gets gray)."""
    cols = [np.array([185, 185, 193], np.uint8)]
    for i in range(1, n_labels):
        h = (i * 0.381966 + 0.11) % 1.0
        cols.append((255 * _hsv(h, 0.85, 0.95)).astype(np.uint8))
    return np.stack(cols)
