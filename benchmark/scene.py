"""The benchmark's scenes, made from the seed on the device: ins_num - 1
objects (boxes and spheres, labels 1..ins_num-1) on a floor (label 0) in
the middle of a ring of cameras, rendered by casting each pixel's ray
against them analytically. The near and far planes of the configuration
bracket the objects; the camera model is the dataset's (DM-SR: Blender
axes, f from camera_angle_x; Replica: OpenCV axes, f = W / 2).

A scene's images and labels are the shared inputs that the program trains
on and the reference reads; the poses of the test views are drawn from the
seed as well.
"""

from __future__ import annotations

import colorsys
import math

import numpy as np
import torch


def intrinsics(cfg: dict) -> np.ndarray:
    H, W = int(cfg["H"]), int(cfg["W"])
    if cfg["camera"] == "blender":
        f = 0.5 * W / math.tan(0.5 * float(cfg["camera_angle_x"]))
        return np.array([[f, 0, 0.5 * W], [0, -f, 0.5 * H], [0, 0, -1.0]], np.float32)
    f = W / 2.0
    return np.array([[f, 0, 0.5 * (W - 1)], [0, f, 0.5 * (H - 1)], [0, 0, 1.0]], np.float32)


def look_at(eye: np.ndarray, target: np.ndarray, camera: str) -> np.ndarray:
    """c2w [4, 4] of a camera at eye looking at target, z up in the world."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    # Blender cameras look along -z with y up; OpenCV cameras along +z, y down
    c2w[:3, :3] = (np.stack([right, up, -fwd], 1) if camera == "blender"
                   else np.stack([right, -up, fwd], 1))
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


def layout(cfg: dict):
    """(camera distance, object ball radius) from the near and far planes."""
    near, far = float(cfg["near"]), float(cfg["far"])
    return near + 0.5 * (far - near), 0.3 * (far - near)


def poses(cfg: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """n cameras around the objects: azimuth uniform, elevation 10-40
    degrees, aimed within a tenth of the ball's radius of its centre."""
    r_cam, r_obj = layout(cfg)
    out = []
    for _ in range(n):
        az, el = rng.uniform(0, 2 * np.pi), np.radians(rng.uniform(10, 40))
        eye = r_cam * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])
        out.append(look_at(eye, rng.uniform(-0.1, 0.1, 3) * r_obj, cfg["camera"]))
    return np.stack(out)


def objects(cfg: dict, rng: np.random.Generator):
    """ins_num - 1 objects on a jittered grid in the ball: (centres [M, 3],
    half-sizes [M, 3], is_sphere [M], colours [M, 3])."""
    m = int(cfg["ins_num"]) - 1
    _, r_obj = layout(cfg)
    g = 2
    while True:                     # the coarsest grid with a cell in the ball for each
        axis = np.linspace(-1, 1, g)
        cells = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
        cells = cells[np.linalg.norm(cells, axis=1) <= 1.0 + 1e-9]
        if len(cells) >= m:
            break
        g += 1
    pick = rng.choice(len(cells), size=m, replace=False)
    step = 2 * r_obj / (g - 1)
    centres = cells[pick] * r_obj * 0.8 + rng.uniform(-0.15, 0.15, (m, 3)) * step
    half = rng.uniform(0.22, 0.4, (m, 3)) * step
    sphere = np.arange(m) % 3 == 0
    half[sphere] = half[sphere, :1]
    colours = np.array([colorsys.hsv_to_rgb((i * 0.381966) % 1.0, 0.75, 0.55 + 0.4 * (i % 2))
                        for i in range(m)])
    return centres, half, sphere, colours


def cast(rays_o, rays_d, scene_objs, floor_z: float, far: float):
    """First hit of each ray [R, 3]: (rgb [R, 3], label [R]). Objects take
    their colour, shaded by the angle of incidence; the floor is grey; a ray
    that hits nothing before `far` sees white and label 0."""
    centres, half, sphere, colours = scene_objs
    o, d = rays_o[:, None, :], rays_d[:, None, :]
    big = torch.full((), float("inf"), device=rays_o.device)
    # boxes: the slab test
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t0 = (centres - half - o) * inv
    t1 = (centres + half - o) * inv
    t_in = torch.minimum(t0, t1).amax(-1)
    t_out = torch.maximum(t0, t1).amin(-1)
    t_box = torch.where((t_out >= t_in) & (t_in > 0), t_in, big)
    # spheres: the nearer root of |o + t d - c|^2 = r^2
    oc = o - centres
    a = (d * d).sum(-1)
    b = (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - half[None, :, 0] ** 2
    disc = b * b - a * c
    t_sph = (-b - torch.sqrt(torch.clamp(disc, min=0))) / a
    t_sph = torch.where((disc >= 0) & (t_sph > 0), t_sph, big)
    t = torch.where(sphere[None, :], t_sph, t_box)
    t_obj, which = t.min(-1)
    t_floor = torch.where(rays_d[:, 2] < 0, (floor_z - rays_o[:, 2]) / rays_d[:, 2], big)
    hit_obj = (t_obj < t_floor) & (t_obj < far)
    hit_floor = ~hit_obj & (t_floor < far)
    p = rays_o + rays_d * t_obj.clamp(max=far)[:, None]
    n_sph = p - centres[which]
    n_sph = n_sph / torch.linalg.norm(n_sph, dim=-1, keepdim=True).clamp(min=1e-9)
    cosang = (n_sph * rays_d).sum(-1).abs() / torch.linalg.norm(rays_d, dim=-1)
    shade = torch.where(sphere[which], 0.45 + 0.55 * cosang, 0.6 + 0.2 * (which % 2))
    rgb = torch.where(hit_obj[:, None], colours[which] * shade[:, None],
                      torch.where(hit_floor[:, None],
                                  torch.tensor([0.55, 0.55, 0.6], device=rays_o.device),
                                  torch.ones_like(rays_o)))
    label = torch.where(hit_obj, which + 1, torch.zeros_like(which))
    return rgb.clamp(0, 1), label


def make(cfg: dict, seed: int, n_views: int, device) -> dict:
    """The training scene of `seed`: images [N, H, W, 3] f32, labels [N, H, W]
    int64, poses [N, 4, 4], K [3, 3], all on `device`, and the object list."""
    rng = np.random.default_rng([int(seed), 1])
    H, W = int(cfg["H"]), int(cfg["W"])
    K = intrinsics(cfg)
    c2ws = poses(cfg, rng, n_views)
    centres, half, sphere, colours = objects(cfg, rng)
    objs = (torch.as_tensor(centres, dtype=torch.float32, device=device),
            torch.as_tensor(half, dtype=torch.float32, device=device),
            torch.as_tensor(sphere, device=device),
            torch.as_tensor(colours, dtype=torch.float32, device=device))
    _, r_obj = layout(cfg)
    Kt = torch.as_tensor(K, device=device)
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    dirs = torch.stack([(i - Kt[0, 2]) / Kt[0, 0], (j - Kt[1, 2]) / Kt[1, 1],
                        Kt[2, 2] * torch.ones_like(i)], -1).reshape(-1, 3)
    P = torch.as_tensor(c2ws, device=device)
    images = torch.empty((n_views, H, W, 3), dtype=torch.float32, device=device)
    labels = torch.empty((n_views, H, W), dtype=torch.int64, device=device)
    for v in range(n_views):
        rd = dirs @ P[v, :3, :3].T
        ro = P[v, :3, 3].expand(rd.shape)
        rgb, lab = cast(ro, rd, objs, -1.1 * r_obj, float(cfg["far"]))
        images[v] = rgb.reshape(H, W, 3)
        labels[v] = lab.reshape(H, W)
    return {"images": images, "labels": labels, "poses": P, "K": Kt}


def test_poses(cfg: dict, seed: int, n: int) -> np.ndarray:
    """n test-view poses of `seed`, apart from the training views."""
    return poses(cfg, np.random.default_rng([int(seed), 2]), n)
