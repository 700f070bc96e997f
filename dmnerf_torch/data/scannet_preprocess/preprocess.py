# Ported from dmnerf_tpu/data/scannet_preprocess/preprocess.py (the label PNGs through utils/png.py::read_png in place of imageio).
"""ScanNet label preprocessing: raw semantic ids -> NYU40 -> 19 training
classes, and per-scene instance re-indexing.

Behavior parity with the reference's data/scannet/source_data/preprocess.py:
- label map from scannetv2-labels.combined.tsv (id -> nyu40id) (:114-124).
- 19 training classes (nyu40 ids [3,4,5,6,7,9,11,13,14,16,17,23,24,28,31,32,
  33,35,36]); other pixels -> -1 (:33-36,136-141).
- instances re-indexed 0..n-1 per image over valid-semantic pixels; each
  instance must map to exactly one semantic class (:144-164).
- outputs {i}.npz with sem_2d_label_id / ins_2d_label_id (consumed by the
  scannet loader).
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict

import numpy as np

from dmnerf_torch.utils.png import read_png

SEM_IDS_TRAIN_CLS19 = [3, 4, 5, 6, 7, 9, 11, 13, 14, 16, 17, 23, 24, 28, 31,
                       32, 33, 35, 36]


def read_label_mapping(filename: str, label_from: str = "id",
                       label_to: str = "nyu40id") -> Dict[int, int]:
    mapping = {}
    with open(filename) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[int(row[label_from])] = int(row[label_to])
    return mapping


def map_sem_nyu(image: np.ndarray, label_mapping: Dict[int, int]) -> np.ndarray:
    out = image.copy()
    for k in np.unique(image):
        if int(k) in label_mapping:
            out[image == k] = label_mapping[int(k)]
    return out


def map_sem_train_ids(image: np.ndarray, train_ids=SEM_IDS_TRAIN_CLS19) -> np.ndarray:
    out = np.full(image.shape, -1, np.int16)
    for new_id, sem in enumerate(train_ids):
        out[image == sem] = new_id
    return out


def map_ins_ids(ins_image: np.ndarray, sem_id: np.ndarray) -> np.ndarray:
    ins = ins_image.copy()
    ins[sem_id == -1] = -1
    out = np.full(ins.shape, -1, np.int16)
    # id assignment order: the reference iterates `list(set(unique) - {-1})`
    # (preprocess.py:146) — CPython set (hash-slot) order, NOT sorted order.
    # The assigned ids persist into the npz artifacts and color_dict.json is
    # keyed by them, so this reproduces that order exactly (same interpreter,
    # same int hashing).
    valid = list(set(np.unique(ins).tolist()) - {-1})
    for new_id, ins_i in enumerate(valid):
        sems = np.unique(sem_id[ins == ins_i])
        if len(sems) > 1:
            raise ValueError(f"instance {ins_i} spans multiple semantic classes")
        out[ins == ins_i] = new_id
    return out


def preprocess_scene(scene_dir: str, label_map_file: str):
    """Process one unzipped scene dir (color/ label-filt/ instance-filt/)."""
    mapping = read_label_mapping(label_map_file)
    n_cls = len(SEM_IDS_TRAIN_CLS19)
    sem_out = os.path.join(scene_dir, f"label-filt-cls{n_cls}")
    ins_out = os.path.join(scene_dir, f"instance-filt-cls{n_cls}")
    os.makedirs(sem_out, exist_ok=True)
    os.makedirs(ins_out, exist_ok=True)

    n_imgs = len(glob.glob(os.path.join(scene_dir, "color", "*.jpg")))
    for i in range(n_imgs):
        sem_raw = np.asarray(read_png(
            os.path.join(scene_dir, "label-filt", f"{i}.png")), np.int16)
        sem_nyu = map_sem_nyu(sem_raw, mapping)
        sem_id = map_sem_train_ids(sem_nyu)
        np.savez_compressed(os.path.join(sem_out, f"{i}.npz"), sem_2d_label_id=sem_id)

        ins_raw = np.asarray(read_png(
            os.path.join(scene_dir, "instance-filt", f"{i}.png")), np.int16)
        ins_id = map_ins_ids(ins_raw, sem_id)
        np.savez_compressed(os.path.join(ins_out, f"{i}.npz"), ins_2d_label_id=ins_id)
    return n_imgs
