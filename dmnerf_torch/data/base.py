# Copied from dmnerf_tpu/data/base.py.
"""Host-side dataset container + dispatch.

The reference returns loose tuples from each loader (loader_dmsr.py:115-140 etc.);
here everything lands in one SceneData so train/test/manipulation/mesh paths share
a single interface. Arrays are numpy on host;
dmnerf_torch/train/step.py::scene_arrays puts what the train step needs on
the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class SceneData:
    images: np.ndarray                 # [N, H, W, 3] f32 in [0, 1]
    poses: np.ndarray                  # [N, 4, 4] f32
    H: int
    W: int
    K: np.ndarray                      # [3, 3]
    i_train: np.ndarray
    i_test: np.ndarray
    gt_labels: np.ndarray              # [N, H, W] int
    ins_rgbs: np.ndarray               # [ins_num(, +), 3] palette
    ins_num: int
    # DM-SR manipulation/mesh metadata (loader_dmsr.py:62-74)
    objs: Optional[List[Dict[str, Any]]] = None
    view_poses: Optional[np.ndarray] = None
    ins_map: Optional[Dict[str, int]] = None
    # ScanNet extras (loader_scannet.py:136-168)
    ins_indices: Optional[List[np.ndarray]] = None  # per-image labeled flat pixel ids
    crop_mask: Optional[np.ndarray] = None          # [H, W] 0/1

    @property
    def hwk(self):
        return self.H, self.W, self.K


def dataset_name_from_dir(datadir: str) -> str:
    parts = [p for p in datadir.replace("\\", "/").split("/") if p and p != "."]
    for p in parts:
        if p in ("dmsr", "replica", "scannet", "synthetic"):
            return p
    # variant dirs keep their family's loader (e.g. replica64 -> replica)
    for p in parts:
        for name in ("dmsr", "replica", "scannet", "synthetic"):
            if p.startswith(name):
                return name
    return parts[-2] if len(parts) >= 2 else "dmsr"


def load_dataset(args) -> SceneData:
    name = dataset_name_from_dir(args.datadir)
    if name == "dmsr":
        from dmnerf_torch.data.dmsr import load_data
    elif name == "replica":
        from dmnerf_torch.data.replica import load_data
    elif name == "scannet":
        from dmnerf_torch.data.scannet import load_data
    elif name == "synthetic":
        from dmnerf_torch.data.synthetic import load_data
    else:
        raise ValueError(f"unknown dataset for datadir={args.datadir!r}")
    return load_data(args)
