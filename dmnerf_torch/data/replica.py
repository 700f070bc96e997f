# Ported from dmnerf_tpu/data/replica.py (PNGs through utils/png.py, the palette through utils/hdf5.py, in place of imageio and h5py).
"""Replica dataset loader.

Behavior parity with the reference's datasets/loader_replica.py:
- 900-frame trajectory traj_w_c.txt, train = every 5th frame, test = train+2,
  testskip thinning on the test ids (:78-88).
- rgb/rgb_{i}.png, semantic_instance/semantic_instance_{i}.png (:33-38,64-68).
- palette ins_rgb.hdf5; ins_num = len(palette).
- K = [[f, 0, (W-1)/2], [0, f, (H-1)/2], [0, 0, 1]], focal = W/2 (:93-94).
"""

from __future__ import annotations

import os

import numpy as np

from dmnerf_torch.data.base import SceneData
from dmnerf_torch.utils.hdf5 import read_dataset
from dmnerf_torch.utils.png import read_png


def load_data(args) -> SceneData:
    total_num, step = 900, 5
    train_ids = list(range(0, total_num, step))
    test_ids = [x + step // 2 for x in train_ids]
    skip_idx = np.arange(0, len(test_ids), args.testskip if args.testskip else 1)

    Ts = np.loadtxt(os.path.join(args.datadir, "traj_w_c.txt"),
                    delimiter=" ").reshape(-1, 4, 4)
    poses = np.concatenate([Ts[train_ids], Ts[test_ids][skip_idx]], 0).astype(np.float32)

    rgb_dir = os.path.join(args.datadir, "rgb")
    tr = np.array([read_png(os.path.join(rgb_dir, f"rgb_{i}.png")) for i in train_ids])
    te = np.array([read_png(os.path.join(rgb_dir, f"rgb_{i}.png")) for i in test_ids])[skip_idx]
    imgs = (np.concatenate([tr, te], 0) / 255.0).astype(np.float32)[..., :3]

    ins_dir = os.path.join(args.datadir, "semantic_instance")
    tr_l = np.array([read_png(os.path.join(ins_dir, f"semantic_instance_{i}.png"))
                     for i in train_ids])
    te_l = np.array([read_png(os.path.join(ins_dir, f"semantic_instance_{i}.png"))
                     for i in test_ids])[skip_idx]
    labels = np.concatenate([tr_l, te_l], 0)

    ins_rgbs = read_dataset(os.path.join(args.datadir, "ins_rgb.hdf5"), "datasets")

    H, W = imgs[0].shape[:2]
    focal = W / 2.0
    K = np.array([[focal, 0, (W - 1) * 0.5], [0, focal, (H - 1) * 0.5], [0, 0, 1.0]])

    return SceneData(images=imgs, poses=poses, H=int(H), W=int(W), K=K,
                     i_train=np.arange(len(train_ids)),
                     i_test=np.arange(len(train_ids), len(train_ids) + len(skip_idx)),
                     gt_labels=labels, ins_rgbs=ins_rgbs, ins_num=len(ins_rgbs))
