# Copied from dmnerf_tpu/data/synthetic.py.
"""Tiny procedural multi-object scene for end-to-end tests (no assets needed).

The reference has no test fixtures at all (SURVEY.md §4); this module provides a
deterministic few-object scene — colored boxes inside a room — rendered by dense
analytic ray marching with the *same compositing math* as the renderer, so a short
training run must drive PSNR up and instance AP toward 1 if the pipeline is wired
correctly.

Camera convention matches DM-SR (loader_dmsr.py:136-137):
K = [[f, 0, W/2], [0, -f, H/2], [0, 0, -1]].
"""

from __future__ import annotations

import numpy as np

from dmnerf_torch.data.base import SceneData

# (center, half_size, color, label) — label 0 is the room itself (cameras sit
# INSIDE the room shell, like the indoor scenes the reference targets)
_BOXES = [
    (np.array([0.0, 0.0, 0.0]), np.array([6.0, 6.0, 6.0]), np.array([0.7, 0.7, 0.75]), 0),
    (np.array([-1.1, -0.7, 0.0]), np.array([0.8, 0.7, 0.9]), np.array([0.9, 0.2, 0.15]), 1),
    (np.array([1.2, 0.3, -0.5]), np.array([0.7, 0.8, 0.7]), np.array([0.1, 0.7, 0.25]), 2),
    (np.array([0.1, 1.2, 0.8]), np.array([0.6, 0.6, 0.65]), np.array([0.2, 0.3, 0.9]), 3),
]
INS_NUM = 4
DENSITY = 60.0


def _pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Same construction as the reference pose_spherical (pose_generator.py:29-34)."""
    th, ph = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    trans = np.eye(4)
    trans[2, 3] = radius
    rot_phi = np.eye(4)
    rot_phi[1, 1], rot_phi[1, 2] = np.cos(ph), -np.sin(ph)
    rot_phi[2, 1], rot_phi[2, 2] = np.sin(ph), np.cos(ph)
    rot_th = np.eye(4)
    rot_th[0, 0], rot_th[0, 2] = np.cos(th), -np.sin(th)
    rot_th[2, 0], rot_th[2, 2] = np.sin(th), np.cos(th)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]])
    return flip @ rot_th @ rot_phi @ trans


def field_at(pts: np.ndarray):
    """Analytic (sigma, rgb, label) at points [..., 3].

    Room box (label 0) is hollow: only a thin shell near its faces is dense, so
    interior cameras see walls. Object boxes are solid.
    """
    sh = pts.shape[:-1]
    sigma = np.zeros(sh, np.float32)
    rgb = np.zeros(sh + (3,), np.float32)
    label = np.zeros(sh, np.int32)

    room_c, room_s, room_col, _ = _BOXES[0]
    d = np.abs(pts - room_c) - room_s
    inside_room = (d < 0).all(-1)
    near_wall = inside_room & (d.max(-1) > -0.4)
    sigma = np.where(near_wall, DENSITY, sigma)
    rgb = np.where(near_wall[..., None], room_col, rgb)

    for c, s, col, lab in _BOXES[1:]:
        inside = (np.abs(pts - c) < s).all(-1)
        sigma = np.where(inside, DENSITY, sigma)
        rgb = np.where(inside[..., None], col, rgb)
        label = np.where(inside, lab, label)
    return sigma, rgb, label


def render_gt(pose: np.ndarray, H: int, W: int, K: np.ndarray,
              near: float, far: float, n_samples: int = 256):
    """Dense-march ground-truth image + per-pixel instance label."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    dirs = np.stack([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
                     K[2, 2] * np.ones_like(i)], -1)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)

    z = np.linspace(near, far, n_samples, dtype=np.float32)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[:, None]
    sigma, rgb, lab = field_at(pts)

    dists = np.diff(z, append=1e10).astype(np.float32)
    dists = dists * np.linalg.norm(rays_d, axis=-1)[..., None]
    alpha = 1.0 - np.exp(-sigma * dists)
    trans = np.cumprod(np.concatenate(
        [np.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    w = alpha * trans
    img = (w[..., None] * rgb).sum(-2)
    # label = label of the max-weight sample
    top = np.argmax(w, axis=-1)
    label_img = np.take_along_axis(lab, top[..., None], axis=-1)[..., 0]
    return img.astype(np.float32), label_img.astype(np.int32)


def make_scene(H: int = 40, W: int = 40, n_train: int = 8, n_test: int = 3,
               near: float = 1.0, far: float = 12.0, radius: float = 4.0) -> SceneData:
    focal = 0.7 * W
    K = np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1.0]])
    thetas = np.linspace(0, 360, n_train + n_test, endpoint=False)
    poses, imgs, labels = [], [], []
    for k, th in enumerate(thetas):
        pose = _pose_spherical(th, -25.0 - 10.0 * (k % 3), radius)
        img, lab = render_gt(pose, H, W, K, near, far)
        poses.append(pose)
        imgs.append(img)
        labels.append(lab)
    palette = np.array([[180, 180, 190], [230, 50, 40], [25, 180, 65], [50, 75, 230]],
                       np.uint8)
    return SceneData(
        images=np.stack(imgs), poses=np.stack(poses).astype(np.float32),
        H=H, W=W, K=K,
        i_train=np.arange(n_train), i_test=np.arange(n_train, n_train + n_test),
        gt_labels=np.stack(labels), ins_rgbs=palette, ins_num=INS_NUM,
    )


def crop_data(H: int, W: int, crop_size) -> np.ndarray:
    """The centred crop mask of data/scannet.py, kept here so that the crop
    scene loads without the ScanNet reader's cv2/h5py/imageio."""
    new_w, new_h = crop_size
    mask = np.zeros((H, W))
    mh, mw = (H - new_h) // 2, (W - new_w) // 2
    mask[mh:H - mh, mw:W - mw] = 1
    return mask.astype(np.int8)


def make_scene_crop(H=48, W=48, n_train=8, n_test=3):
    """ScanNet-style variant: the room (label 0) becomes the UNLABELED class
    (remapped to ins_num), objects relabel to 0..K-2, a center crop mask and
    per-image labeled-pixel index lists are attached — exercises the
    weakly-supervised 30%-labeled sampler and the masked eval path."""
    sc = make_scene(H=H, W=W, n_train=n_train, n_test=n_test)
    ins_num = INS_NUM - 1  # objects only; room -> unlabeled
    labels = sc.gt_labels.astype(np.int32) - 1
    labels[labels < 0] = ins_num
    sc.gt_labels = labels
    sc.ins_num = ins_num
    sc.ins_rgbs = sc.ins_rgbs[1:]

    sc.crop_mask = crop_data(H, W, [int(W * 0.8), int(H * 0.8)])
    flat_mask = sc.crop_mask.reshape(-1)
    sc.ins_indices = []
    for lab in labels:
        flat = lab.reshape(-1).copy()
        flat[flat_mask == 0] = ins_num
        sc.ins_indices.append(np.where(flat != ins_num)[0].astype(np.int32))
    return sc


def load_data(args) -> SceneData:
    """datadir may end in digits to pick resolution (e.g. .../boxroom64) and
    optionally 'xN' for view count (.../boxroom64x16); a name containing
    'crop' selects the ScanNet-style weakly-supervised variant."""
    import re

    name = args.datadir.rstrip("/").split("/")[-1]
    maker = make_scene_crop if "crop" in name else make_scene
    m = re.search(r"(\d+)(?:x(\d+))?$", name)
    if m:
        res = int(m.group(1))
        n_views = int(m.group(2)) if m.group(2) else 12
        n_test = max(2, n_views // 4)
        return maker(H=res, W=res, n_train=n_views - n_test, n_test=n_test)
    return maker()
