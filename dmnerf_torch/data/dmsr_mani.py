# Ported from dmnerf_tpu/data/dmsr_mani.py (PNGs through utils/png.py, the palette through utils/hdf5.py, in place of imageio and h5py).
"""DM-SR manipulation ground truth loader (GT renders of manipulated scenes).

Behavior parity with the reference's datasets/loader_dmsr_mani.py:
- mani/{mode}/rgbs + mani/{mode}/semantic_instance + mani/transforms.json,
  testskip thinning, palette from ins_rgb.hdf5, DM-SR K convention (:19-62).
"""

from __future__ import annotations

import json
import os

import numpy as np

from dmnerf_torch.data.base import SceneData
from dmnerf_torch.utils.hdf5 import read_dataset
from dmnerf_torch.utils.png import read_png


def load_data(args) -> SceneData:
    skip = 1 if args.testskip == 0 else args.testskip
    base = os.path.join(args.datadir, "mani", args.mani_mode)
    rgb_files = sorted(os.listdir(os.path.join(base, "rgbs")))
    rgbs = np.array([read_png(os.path.join(base, "rgbs", f)) for f in rgb_files])

    with open(os.path.join(args.datadir, "mani", "transforms.json")) as f:
        meta = json.load(f)
    poses = np.array([fr["transform_matrix"] for fr in meta["frames"][::skip]], np.float32)

    idx = np.arange(0, len(rgbs), skip)
    rgbs = (rgbs[idx] / 255.0).astype(np.float32)[..., :3]

    ins_dir = os.path.join(base, "semantic_instance")
    labels = np.array([read_png(os.path.join(ins_dir, f))
                       for f in sorted(os.listdir(ins_dir))])[idx]

    ins_rgbs = read_dataset(os.path.join(args.datadir, "ins_rgb.hdf5"), "datasets")

    H, W = rgbs[0].shape[:2]
    focal = 0.5 * W / np.tan(0.5 * meta["camera_angle_x"])
    K = np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1.0]])

    n = len(rgbs)
    return SceneData(images=rgbs, poses=poses, H=int(H), W=int(W), K=K,
                     i_train=np.arange(0), i_test=np.arange(n),
                     gt_labels=labels, ins_rgbs=ins_rgbs, ins_num=len(ins_rgbs))
