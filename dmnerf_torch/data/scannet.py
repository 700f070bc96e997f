# Ported from dmnerf_tpu/data/scannet.py (the JPEG frames through utils/jpeg.py, the palette through utils/hdf5.py, the nearest resize in numpy).
"""ScanNet dataset loader.

Behavior parity with the reference's datasets/loader_scannet.py:
- frame ids from {train,test}_split.txt; jpgs under {split}/{split}_images,
  per-frame pose txt under {split}/{split}_pose (:66-73).
- instances from {split}/{split}_ins/{id}.npz field 'ins_2d_label_id' (:17-20,117-118).
- optional nearest-neighbor resize to 480x640 (cv2.INTER_NEAREST's index
  rule, in numpy); intrinsics from intrinsic/intrinsic_{color|depth}.txt
  (depth when resized) (:32-41,91-95).
- ins_num = #unique - 1; unlabeled (-1) remapped to ins_num ("air"); palette
  truncated to ins_num (:130-133).
- center crop mask of (crop_width, crop_height) (:23-29,165); per-image labeled
  flat pixel indices within the crop (:136-148).

The .jpg frames are read by utils/jpeg.py::read_jpeg, which gives what
imageio.v2.imread gives through Pillow, to the bit.
"""

from __future__ import annotations

import os

import numpy as np

from dmnerf_torch.data.base import SceneData
from dmnerf_torch.utils.hdf5 import read_dataset
from dmnerf_torch.utils.jpeg import read_jpeg


def crop_data(H: int, W: int, crop_size) -> np.ndarray:
    new_w, new_h = crop_size
    mask = np.zeros((H, W))
    mh, mw = (H - new_h) // 2, (W - new_w) // 2
    mask[mh:H - mh, mw:W - mw] = 1
    return mask.astype(np.int8)


def nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2.resize's INTER_NEAREST source index of each of dst outputs:
    floor(x * (1 / (dst / src))), clamped to src - 1."""
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64), src - 1)


def _resize(data: np.ndarray, H: int = 480, W: int = 640) -> np.ndarray:
    rows = nearest_index(data.shape[1], H)
    cols = nearest_index(data.shape[2], W)
    return data[:, rows][:, :, cols].astype(np.float64)


def _load_split_imgs(datadir, split, skip, resize):
    indices = np.loadtxt(os.path.join(datadir, f"{split}_split.txt")).astype(np.int32)
    base = os.path.join(datadir, split)
    rgbs = np.array([read_jpeg(os.path.join(base, f"{split}_images", f"{i}.jpg"))
                     for i in indices])
    poses = np.array([np.loadtxt(os.path.join(base, f"{split}_pose", f"{i}.txt"),
                                 delimiter=" ") for i in indices])
    sel = np.arange(0, len(poses), skip)
    rgbs = (rgbs[sel] / 255.0).astype(np.float32)
    if resize:
        rgbs = _resize(rgbs).astype(np.float32)
    return rgbs, poses[sel].astype(np.float32), indices[sel]


def _load_split_ins(datadir, split, skip, resize):
    indices = np.loadtxt(os.path.join(datadir, f"{split}_split.txt")).astype(np.int32)
    base = os.path.join(datadir, split)
    labels = np.array([np.load(os.path.join(base, f"{split}_ins", f"{i}.npz"))["ins_2d_label_id"]
                       for i in indices])
    labels = labels[np.arange(0, len(labels), skip)]
    if resize:
        labels = _resize(labels)
    return labels


def load_data(args) -> SceneData:
    skip = 1 if args.testskip == 0 else args.testskip
    tr_imgs, tr_poses, _ = _load_split_imgs(args.datadir, "train", 1, args.resize)
    te_imgs, te_poses, _ = _load_split_imgs(args.datadir, "test", skip, args.resize)
    imgs = np.concatenate([tr_imgs, te_imgs], 0)
    poses = np.concatenate([tr_poses, te_poses], 0)
    i_train = np.arange(len(tr_imgs))
    i_test = np.arange(len(tr_imgs), len(imgs))

    tr_l = _load_split_ins(args.datadir, "train", 1, args.resize)
    te_l = _load_split_ins(args.datadir, "test", skip, args.resize)
    labels = np.concatenate([tr_l, te_l], 0).astype(np.int8)

    ins_rgbs = read_dataset(os.path.join(args.datadir, "ins_rgb.hdf5"), "datasets")
    ins_num = len(np.unique(labels)) - 1
    ins_rgbs = ins_rgbs[:ins_num]
    labels = labels.astype(np.int32)
    labels[labels == -1] = ins_num

    intr_name = "intrinsic_depth.txt" if args.resize else "intrinsic_color.txt"
    K = np.loadtxt(os.path.join(args.datadir, "intrinsic", intr_name), delimiter=" ")

    H, W = imgs[0].shape[:2]
    crop_mask = crop_data(H, W, [args.crop_width, args.crop_height])

    # per-image labeled pixel indices within the crop (loader_scannet.py:136-148)
    flat_mask = crop_mask.reshape(-1)
    ins_indices = []
    for lab in labels:
        flat = lab.reshape(-1).copy()
        flat[flat_mask == 0] = ins_num
        ins_indices.append(np.where(flat != ins_num)[0].astype(np.int32))

    return SceneData(images=imgs, poses=poses, H=int(H), W=int(W), K=K[:3, :3],
                     i_train=i_train, i_test=i_test, gt_labels=labels,
                     ins_rgbs=ins_rgbs, ins_num=ins_num,
                     ins_indices=ins_indices, crop_mask=crop_mask)
