# Ported from dmnerf_tpu/data/scannet_preprocess/split.py (cv2's INTER_NEAREST resize through data/scannet.py::nearest_index).
"""ScanNet train/test frame split.

Behavior parity with the reference's data/scannet/split.py:143-180:
- keep frames with >= 1 instance after resize-to-640x480 + center-crop 600x450,
- train = every (len//number)-th valid frame,
- test = offset by half a step, thinned to ~`number` frames,
- writes {train,test}_split.txt and copies images/poses/depth/ins npzs into the
  train/ and test/ layout the scannet loader reads.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from dmnerf_torch.data.scannet import nearest_index


def _ins_count(npz_path: str) -> int:
    ins = np.load(npz_path)["ins_2d_label_id"]
    ins = ins[nearest_index(ins.shape[0], 480)][:, nearest_index(ins.shape[1], 640)]
    H, W = ins.shape
    mh, mw = (H - 450) // 2, (W - 600) // 2
    ins = ins[mh:H - mh, mw:W - mw]
    return len(np.unique(ins)[1:])  # drop -1


def split_evenly(scene_dir: str, save_dir: str, number: int = 300):
    ins_dir = os.path.join(scene_dir, "instance-filt-cls19")
    n = len(os.listdir(ins_dir))
    counts = np.array([_ins_count(os.path.join(ins_dir, f"{i}.npz"))
                       for i in range(n)])
    val_ids = np.where(counts != 0)[0]
    amounts = len(val_ids)
    step = max(amounts // number, 1)
    train_idx = list(range(0, amounts, step))
    train_ids = val_ids[train_idx]
    test_idx = np.array([x + step // 2 for x in train_idx
                         if (x + step) < (amounts - 1)])
    margin = len(test_idx) - number + 100
    start = max(margin // 2, 0)
    end = len(test_idx) - start
    sel = np.arange(start, end, 2).astype(int)
    test_ids = val_ids[test_idx[sel]] if len(sel) else val_ids[test_idx]

    scene_name = os.path.basename(scene_dir.rstrip("/"))
    out = os.path.join(save_dir, scene_name)
    os.makedirs(out, exist_ok=True)
    np.savetxt(os.path.join(out, "train_split.txt"), train_ids, fmt="%i")
    np.savetxt(os.path.join(out, "test_split.txt"), test_ids, fmt="%i")

    for split, ids in (("train", train_ids), ("test", test_ids)):
        base = os.path.join(out, split)
        for sub in (f"{split}_images", f"{split}_pose", f"{split}_depth",
                    f"{split}_ins"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        for idx in ids:
            shutil.copy(os.path.join(scene_dir, "color", f"{idx}.jpg"),
                        os.path.join(base, f"{split}_images", f"{idx}.jpg"))
            shutil.copy(os.path.join(scene_dir, "pose", f"{idx}.txt"),
                        os.path.join(base, f"{split}_pose", f"{idx}.txt"))
            shutil.copy(os.path.join(scene_dir, "depth", f"{idx}.png"),
                        os.path.join(base, f"{split}_depth", f"{idx}.png"))
            shutil.copy(os.path.join(ins_dir, f"{idx}.npz"),
                        os.path.join(base, f"{split}_ins", f"{idx}.npz"))
    shutil.copy(os.path.join(scene_dir, "intrinsic", "intrinsic_color.txt"),
                os.path.join(out, "intrinsic_color.txt")) if os.path.exists(
        os.path.join(scene_dir, "intrinsic", "intrinsic_color.txt")) else None
    intr_src = os.path.join(scene_dir, "intrinsic")
    if os.path.isdir(intr_src):
        shutil.copytree(intr_src, os.path.join(out, "intrinsic"),
                        dirs_exist_ok=True)
    return train_ids, test_ids
