# Ported from dmnerf_tpu/data/dmsr.py (PNGs through utils/png.py, the palette through utils/hdf5.py, in place of imageio and h5py).
"""DM-SR dataset loader (Blender-style synthetic rooms).

Behavior parity with the reference's datasets/loader_dmsr.py:
- train|test/rgbs/*.png (sorted) + per-split transforms.json with
  camera_angle_x and per-frame transform_matrix (:38-45).
- testskip applied to the test split only (:27-31).
- instance maps from train|test/semantic_instance/*.png; palette from
  ins_rgb.hdf5 ('datasets'); ins_num = len(palette) (:90-112).
- K = [[f, 0, W/2], [0, -f, H/2], [0, 0, -1]], f = 0.5 W / tan(0.5 angle_x) (:136-137).
- mesh/mani_demo mode loads mani/objs_info_{rigid,deform}.json (objects,
  view_id, ins_map) (:62-74); test-time spherical view poses (:122-126).
"""

from __future__ import annotations

import json
import os

import numpy as np

from dmnerf_torch.data.base import SceneData
from dmnerf_torch.utils.hdf5 import read_dataset
from dmnerf_torch.utils.png import read_png
from dmnerf_torch.edit.transforms import pose_spherical


def _load_split(basedir: str, split: str, skip: int):
    rgb_dir = os.path.join(basedir, split, "rgbs")
    files = sorted(os.listdir(rgb_dir))
    imgs = [read_png(os.path.join(rgb_dir, f)) for f in files]
    with open(os.path.join(basedir, split, "transforms.json")) as f:
        meta = json.load(f)
    poses = np.array([fr["transform_matrix"] for fr in meta["frames"][::skip]],
                     np.float32)
    if poses.shape[-1] == 16:
        poses = poses.reshape(-1, 4, 4)
    idx = np.arange(0, len(imgs), skip)
    imgs = (np.array(imgs)[idx] / 255.0).astype(np.float32)[..., :3]

    ins_dir = os.path.join(basedir, split, "semantic_instance")
    ins_files = sorted(os.listdir(ins_dir))
    labels = np.array([read_png(os.path.join(ins_dir, f)) for f in ins_files])[idx]
    return imgs, poses, labels, meta["camera_angle_x"]


def load_data(args) -> SceneData:
    skip_test = 1 if args.testskip == 0 else args.testskip
    tr_imgs, tr_poses, tr_labels, angle_x = _load_split(args.datadir, "train", 1)
    te_imgs, te_poses, te_labels, _ = _load_split(args.datadir, "test", skip_test)

    imgs = np.concatenate([tr_imgs, te_imgs], 0)
    poses = np.concatenate([tr_poses, te_poses], 0)
    labels = np.concatenate([tr_labels, te_labels], 0)
    i_train = np.arange(len(tr_imgs))
    i_test = np.arange(len(tr_imgs), len(imgs))

    ins_rgbs = read_dataset(os.path.join(args.datadir, "ins_rgb.hdf5"), "datasets")
    ins_num = len(ins_rgbs)

    objs = view_poses = ins_map = None
    if getattr(args, "mesh", False) or getattr(args, "mani_demo", False):
        name = "objs_info_rigid.json" if args.mani_type == "rigid" else "objs_info_deform.json"
        with open(os.path.join(args.datadir, "mani", name)) as f:
            info = json.load(f)
        objs, view_id, ins_map = info["objects"], info["view_id"], info["ins_map"]
        view_poses = np.repeat(poses[view_id][None], args.views, axis=0)
    elif not getattr(args, "is_train", True):
        view_poses = np.stack(
            [pose_spherical(a, -65.0, 7.0) for a in np.linspace(0, 180, args.views)], 0)

    H, W = imgs[0].shape[:2]
    focal = 0.5 * W / np.tan(0.5 * angle_x)
    K = np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1.0]])

    return SceneData(images=imgs, poses=poses, H=int(H), W=int(W), K=K,
                     i_train=i_train, i_test=i_test, gt_labels=labels,
                     ins_rgbs=ins_rgbs, ins_num=ins_num,
                     objs=objs, view_poses=view_poses, ins_map=ins_map)
