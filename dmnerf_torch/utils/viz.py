# Copied from dmnerf_tpu/utils/viz.py.
"""Label-map visualization (host-side).

Behavior parity with the reference's tools/visualizer.py:57-86,208-223:
- render_label2img: predicted label map -> RGB via the run's pred->gt matching
  (ins_map) composed with the scene's color_dict (gt label -> palette index).
- render_gt_label2img: gt label map -> RGB via color_dict.
- render_label2world: same mapping for per-vertex mesh labels.
Unmapped labels stay black.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def _map_labels(labels: np.ndarray, rgbs: np.ndarray, get_rgb) -> np.ndarray:
    out = np.zeros(labels.shape + (3,), np.float64)
    for lab in np.unique(labels):
        rgb = get_rgb(int(lab))
        if rgb is not None:
            out[labels == lab] = rgb
    return out.astype(np.uint8)


def render_label2img(pred_labels: np.ndarray, ins_rgbs: np.ndarray,
                     color_dict: Dict[str, int], ins_map: Dict[str, int]) -> np.ndarray:
    def get(lab):
        key = str(lab)
        if key in ins_map:
            return ins_rgbs[color_dict[str(ins_map[key])]]
        return None
    return _map_labels(np.asarray(pred_labels), ins_rgbs, get)


def render_gt_label2img(gt_labels: np.ndarray, ins_rgbs: np.ndarray,
                        color_dict: Dict[str, int]) -> np.ndarray:
    def get(lab):
        key = str(lab)
        if key in color_dict:
            return ins_rgbs[color_dict[key]]
        return None
    return _map_labels(np.asarray(gt_labels), ins_rgbs, get)


def render_label2world(pred_labels: np.ndarray, ins_rgbs: np.ndarray,
                       color_dict: Dict[str, int], ins_map: Dict[str, int]) -> np.ndarray:
    """Per-vertex labels [N] -> colors [N, 3]."""
    return render_label2img(pred_labels, ins_rgbs, color_dict, ins_map)


def load_color_dict(path: str, dataset_name: str, scene_name: str) -> Dict[str, int]:
    import json
    with open(path) as f:
        return json.load(f)[dataset_name][scene_name]


def ins2img(ins_probs: np.ndarray, ins_rgbs: np.ndarray) -> np.ndarray:
    """Argmax of an instance-probability map -> palette colors; label 0 black
    (visualizer.py:7-19)."""
    labels = np.argmax(np.asarray(ins_probs), axis=-1)

    def get(lab):
        return None if lab == 0 else ins_rgbs[lab]
    return _map_labels(labels, ins_rgbs, get)


def matching_label2img(pred_labels: np.ndarray, rgbs: np.ndarray) -> np.ndarray:
    """Matched-label map -> colors; -1 black, -2 white (visualizer.py:38-54)."""
    def get(lab):
        if lab == -1:
            return [0, 0, 0]
        if lab == -2:
            return [255, 255, 255]
        return rgbs[lab]
    return _map_labels(np.asarray(pred_labels), rgbs, get)


def show_instance_rgb(ins_rgbs: np.ndarray, save_path: str):
    """Palette contact sheet (visualizer.py:90-107)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(ins_rgbs)
    y_ax = 4
    x_ax = max((n + y_ax - 1) // y_ax, 1)
    fig, ax = plt.subplots(x_ax, y_ax, figsize=(8, 8), squeeze=False)
    for i in range(x_ax * y_ax):
        a = ax[i // y_ax][i % y_ax]
        a.axis("off")
        if i < n:
            rgb = ins_rgbs[i]
            a.imshow(np.tile(np.asarray(rgb, np.uint8), (8, 8, 1)))
            a.set_title(f"Label:{i}: [{rgb[0]},{rgb[1]},{rgb[2]}]",
                        fontdict={"fontsize": 6})
    fig.savefig(save_path)
    plt.close(fig)
