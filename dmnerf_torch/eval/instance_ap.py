"""Instance decomposition evaluation: Hungarian-matched per-object IoU and
COCO-style integral AP at thresholds {0.50, 0.75, 0.80, 0.85, 0.90, 0.95}.

Behavior parity with the reference DM-NeRF's networks/evaluator.py:77-175:
- pred labels = argmax of the composited instance map; with a mask (ScanNet
  crop) out-of-mask pixels get label ins_num and the last unique is dropped.
- per-object confidence = median of per-pixel max prob within the object.
- pred one-hots placed in gt-slot layout, Hungarian on BCE+soft-IoU cost over
  the gt-valid rows, per-gt-object IoU = 1 - cost_iou at the matched column.
- AP by sorting IoUs by confidence (descending), tp = IoU > thr, precision /
  recall cumsums, COCO integral interpolation.

Runs on host (numpy + scipy LSA): this is a per-test-image path, not the train
hot loop.

Copied from dmnerf_tpu/eval/instance_ap.py, unchanged but for docstrings:
the JAX package's eval/__init__.py imports its renderer, and with it jax, so
the original cannot be imported on a machine without jax.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

THRESHOLDS = [0.5, 0.75, 0.8, 0.85, 0.9, 0.95]


def _cost_matrices(pred_oh: np.ndarray, gt_oh: np.ndarray):
    """pred_oh, gt_oh: [N, K] -> cost_ce, cost_siou [K_gt, K_pred]."""
    n = pred_oh.shape[0]
    p = pred_oh.astype(np.float64)
    g = gt_oh.astype(np.float64)
    logp = np.log(p + 1e-8)
    log1mp = np.log(1 - p + 1e-8)
    ce = (-(g.T @ logp) - ((1 - g).T @ log1mp)) / n
    tp = g.T @ p
    fp = p.sum(0)[None, :] - tp
    fn = g.sum(0)[:, None] - tp
    siou = tp / (tp + fp + fn + 1e-6)
    return ce, 1.0 - siou


def hungarian(pred_ins: np.ndarray, gt_ins: np.ndarray, valid_ins_num: int,
              ins_num: int):
    """Reference-identical matcher (evaluator.py:41-74) on host arrays.

    pred_ins, gt_ins: [N, K]. Returns cost_ce, cost_siou, order_row, order_col
    (order_col padded with unmatched columns ascending).
    """
    cost_ce, cost_siou = _cost_matrices(pred_ins, gt_ins)
    cost = (cost_ce + cost_siou)[:valid_ins_num]
    row_ind, col_ind = linear_sum_assignment(cost)
    unmatched = sorted(set(range(ins_num)) - set(col_ind.tolist()))
    order_col = np.concatenate([col_ind, np.array(unmatched, dtype=col_ind.dtype)]) \
        if unmatched else col_ind
    return cost_ce, cost_siou, row_ind, order_col


def calculate_ap(ious: np.ndarray, gt_number: int,
                 confidence: Optional[np.ndarray] = None,
                 function_select: str = "integral") -> List[float]:
    if confidence is not None:
        order = np.argsort(-confidence, kind="stable")
        ranked = ious[order]
    else:
        ranked = np.sort(ious)[::-1]

    aps = []
    for thr in THRESHOLDS:
        tp = (ranked > thr).astype(np.float64)
        csum = np.cumsum(tp)
        prec = csum / (np.arange(len(tp)) + 1)
        rec = csum / gt_number
        if function_select == "integral":
            mrec = np.concatenate([[0.0], rec, [1.0]])
            mprec = np.concatenate([[0.0], prec, [0.0]])
            for i in range(len(mprec) - 1, 0, -1):
                mprec[i - 1] = max(mprec[i - 1], mprec[i])
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            aps.append(float(np.sum((mrec[idx + 1] - mrec[idx]) * mprec[idx + 1])))
        else:  # 11-point interpolation
            ap = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                p = prec[rec >= t].max() if (rec >= t).any() else 0.0
                ap += p / 11.0
            aps.append(float(ap))
    return aps


def ins_eval(pred_ins: np.ndarray, gt_label: np.ndarray, ins_num: int,
             mask: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, List[float], np.ndarray]:
    """Evaluate one view from the full probability map.

    pred_ins: [H, W, K] composited instance probabilities;
    gt_label: [H, W] int labels; mask: optional [H, W] 0/1 (ScanNet crop:
    out-of-mask prediction pixels are excluded).
    Returns (pred_label [H, W], ap[6], matched gt-order pred labels [-1 = none]).
    """
    pred_ins = np.asarray(pred_ins)
    return ins_eval_from_labels(np.argmax(pred_ins, axis=-1), pred_ins.max(-1),
                                gt_label, ins_num, mask)


def ins_eval_from_labels(pred_label: np.ndarray, conf_map: np.ndarray,
                         gt_label: np.ndarray, ins_num: int,
                         mask: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, List[float], np.ndarray]:
    """ins_eval taking the device-side reduction (argmax label + max prob) —
    the full [H,W,K] map is only ever consumed through these two reductions
    (evaluator.py:130-146), and shipping them instead of the map cuts the
    eval's device->host bytes from K values per pixel to two."""
    gt_label = np.asarray(gt_label).astype(np.int64)
    pred_label = np.asarray(pred_label).astype(np.int64)
    conf_map = np.asarray(conf_map)

    if mask is not None:
        pred_label = pred_label.copy()
        pred_label[mask == 0] = ins_num
        # the reference drops unique()[:-1] assuming ins_num is present
        # (evaluator.py:133); filtering by value is identical whenever it is,
        # and correct when an all-ones mask leaves no air pixel
        valid_pred_labels = np.unique(pred_label)
        valid_pred_labels = valid_pred_labels[valid_pred_labels != ins_num]
    else:
        valid_pred_labels = np.unique(pred_label)
    valid_pred_num = len(valid_pred_labels)

    # per-object confidence: median of per-pixel max prob (evaluator.py:137-146)
    pred_conf = np.array([np.median(conf_map[pred_label == lab])
                          for lab in valid_pred_labels])

    # gt one-hot in slot layout
    valid_gt_labels = np.unique(gt_label) if mask is None else \
        np.unique(np.where(mask == 0, np.int64(ins_num), gt_label))
    if mask is not None:
        valid_gt_labels = valid_gt_labels[valid_gt_labels != ins_num]
    gt_num = len(valid_gt_labels)
    if gt_num == 0:
        # reference fallback for a view with zero labeled GT instances
        # (tester.py:106-118): pred_label = -1 everywhere, AP = 1.0
        return (-np.ones_like(gt_label), [1.0] * len(THRESHOLDS),
                np.zeros((0,), np.int64))
    N = gt_label.size
    gt_oh = np.zeros((N, ins_num), np.float32)
    for slot, lab in enumerate(valid_gt_labels):
        gt_oh[(gt_label.reshape(-1) == lab), slot] = 1.0

    pred_oh = np.zeros((N, ins_num), np.float32)
    for slot, lab in enumerate(valid_pred_labels):
        pred_oh[(pred_label.reshape(-1) == lab), slot] = 1.0

    _, cost_iou, order_row, order_col = hungarian(pred_oh, gt_oh, gt_num, ins_num)
    valid_inds = order_col[:gt_num].copy()
    ious = 1.0 - cost_iou[order_row, valid_inds]

    confidence = np.zeros(gt_num)
    for i, vi in enumerate(valid_inds):
        confidence[i] = pred_conf[vi] if vi < valid_pred_num else 0.0

    ap = calculate_ap(ious, gt_num, confidence=confidence)

    invalid = valid_inds >= valid_pred_num
    valid_inds[invalid] = 0
    matched = np.asarray(valid_pred_labels)[valid_inds].astype(np.int64)
    matched[invalid] = -1
    return pred_label, ap, matched
