"""Hungarian-matched instance loss: per-slot BCE + soft-IoU (port of
dmnerf_tpu/losses/instance.py; reference networks/evaluator.py:19-74).

- GT labels are one-hot'd into the first `valid` slots of a fixed [N, K]
  buffer, slots ordered by ascending label id (torch.unique ordering).
- cost_ce[k, c] = mean over rays of BCE(pred[:, c], gt[:, k]), in the
  softplus form when the pre-sigmoid logits are given.
- cost_siou[k, c] = 1 - TP/(TP+FP+FN+1e-6), TP = sum pred*gt.
- matching on cost_ce + cost_siou over the valid rows (ops/lap.py, on the
  host); loss = mean matched CE + mean over unmatched pred columns + mean
  matched (1 - sIoU).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dmnerf_torch.ops.lap import lap_square


class InsLoss(NamedTuple):
    total: torch.Tensor
    valid_ce: torch.Tensor
    invalid_ce: torch.Tensor
    valid_siou: torch.Tensor


def build_gt_onehot(gt_labels: torch.Tensor, ins_num: int):
    """gt_labels [N] int in [0, ins_num) -> (gt [N, K] one-hot into slots
    ordered by ascending present label id, row_valid [K] bool, valid_num)."""
    labels = gt_labels.long()
    presence = torch.bincount(labels, minlength=ins_num)[:ins_num] > 0
    valid_num = presence.sum()
    rank = torch.cumsum(presence.long(), 0) - 1                 # label id -> slot
    gt = F.one_hot(rank[labels], ins_num).float()
    row_valid = torch.arange(ins_num, device=labels.device) < valid_num
    return gt, row_valid, valid_num


def cost_matrices(pred: torch.Tensor, gt: torch.Tensor,
                  logits: Optional[torch.Tensor] = None):
    """(cost_ce, cost_siou) [K_gt_slots, K_pred_cols] as matmuls. pred [N, K]
    in (0, 1), gt [N, K] one-hot, logits the optional pre-sigmoid map (exact
    BCE: -log sigmoid(x) = softplus(-x))."""
    n = pred.shape[0]
    gt = gt.to(pred.dtype)
    if logits is not None:
        logp, log1mp = -F.softplus(-logits), -F.softplus(logits)
    else:
        logp, log1mp = torch.log(pred + 1e-8), torch.log(1.0 - pred + 1e-8)
    cost_ce = (-(gt.T @ logp) - ((1.0 - gt).T @ log1mp)) / n
    tp = gt.T @ pred
    fp = pred.sum(0)[None, :] - tp
    fn = gt.sum(0)[:, None] - tp
    return cost_ce, 1.0 - tp / (tp + fp + fn + 1e-6)


def ins_criterion_pair(pred_coarse: torch.Tensor, pred_fine: torch.Tensor,
                       gt_labels: torch.Tensor, ins_num: int,
                       logits_coarse: Optional[torch.Tensor] = None,
                       logits_fine: Optional[torch.Tensor] = None):
    """Coarse and fine instance losses; both assignments come from one copy of
    the two [K, K] costs to the host and one solver call each there."""
    gt, row_valid, valid_num = build_gt_onehot(gt_labels, ins_num)
    ce_c, siou_c = cost_matrices(pred_coarse, gt, logits_coarse)
    ce_f, siou_f = cost_matrices(pred_fine, gt, logits_fine)
    cost = torch.stack([ce_c + siou_c, ce_f + siou_f]).detach()
    cost = torch.where(row_valid[None, :, None], cost, 0.0)
    host = torch.cat([cost.reshape(-1).double(), valid_num.double()[None]]).cpu().numpy()
    nv = int(host[-1])
    costs = host[:-1].reshape(2, ins_num, ins_num)
    col4rows = torch.from_numpy(np.stack([lap_square(c, nv) for c in costs])).to(gt.device)
    return tuple(_matched_loss(ce, siou, pred.mean(0), row_valid, valid_num, ins_num, c4r)
                 for ce, siou, pred, c4r in ((ce_c, siou_c, pred_coarse, col4rows[0]),
                                             (ce_f, siou_f, pred_fine, col4rows[1])))


def _matched_loss(cost_ce, cost_siou, col_mean_pred, row_valid, valid_num,
                  ins_num: int, col4row) -> InsLoss:
    rows = torch.arange(ins_num, device=cost_ce.device)
    vmask = row_valid.to(cost_ce.dtype)
    denom = torch.clamp(valid_num.to(cost_ce.dtype), min=1.0)
    valid_ce = torch.sum(cost_ce[rows, col4row] * vmask) / denom
    valid_siou = torch.sum(cost_siou[rows, col4row] * vmask) / denom
    matched = torch.zeros(ins_num, dtype=cost_ce.dtype, device=cost_ce.device)
    matched = matched.index_add(0, col4row, vmask)
    unmatched = 1.0 - torch.clamp(matched, max=1.0)
    n_unmatched = unmatched.sum()
    invalid_ce = torch.where(n_unmatched > 0,
                             torch.sum(col_mean_pred * unmatched)
                             / torch.clamp(n_unmatched, min=1.0),
                             torch.zeros((), dtype=cost_ce.dtype, device=cost_ce.device))
    return InsLoss(valid_ce + invalid_ce + valid_siou, valid_ce, invalid_ce, valid_siou)
