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

Under a ray mesh (parallel/mesh.py) each rank holds some of the rays. The
presence of each label (its count), and the per-rank partials gt.T @ logp,
(1-gt).T @ log1mp, tp = gt.T @ pred, the column sums of pred and gt and the
column means of pred (weighted by the rank's share of the n_rays rays) are
summed across ranks (psum) before cost_ce (over the global n_rays), sIoU
and the matching; every rank then solves the same [2, K, K] on the host, and
ins_loss_from_stats makes the loss from the summed statistics. A rank with
none of the rays contributes zeros.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dmnerf_torch.ops.lap import lap_square
from dmnerf_torch.parallel.mesh import DataMesh, psum
from dmnerf_torch.utils.profiling import span


class InsLoss(NamedTuple):
    total: torch.Tensor
    valid_ce: torch.Tensor
    invalid_ce: torch.Tensor
    valid_siou: torch.Tensor


def build_gt_onehot(gt_labels: torch.Tensor, ins_num: int, mesh: Optional[DataMesh] = None):
    """gt_labels [N] int in [0, ins_num) -> (gt [N, K] one-hot into slots
    ordered by ascending label id present on any rank, row_valid [K] bool,
    valid_num)."""
    labels = gt_labels.long()
    # the count of each label by a scatter of ones: torch.bincount reads the
    # labels' min and max on the host, which waits for the device
    counts = torch.zeros(ins_num, dtype=torch.long, device=labels.device)
    presence = psum(counts.index_add_(0, labels, torch.ones_like(labels)), mesh) > 0
    valid_num = presence.sum()
    rank = torch.cumsum(presence.long(), 0) - 1                 # label id -> slot
    gt = F.one_hot(rank[labels], ins_num).float()
    row_valid = torch.arange(ins_num, device=labels.device) < valid_num
    return gt, row_valid, valid_num


def cost_matrices(pred: torch.Tensor, gt: torch.Tensor,
                  logits: Optional[torch.Tensor] = None,
                  mesh: Optional[DataMesh] = None, n_rays: Optional[int] = None):
    """(cost_ce, cost_siou) [K_gt_slots, K_pred_cols] as matmuls. pred [N, K]
    in (0, 1), gt [N, K] one-hot, logits the optional pre-sigmoid map (exact
    BCE: -log sigmoid(x) = softplus(-x)). Under a mesh, n_rays is the count
    of rays over all ranks."""
    n = pred.shape[0] if mesh is None else n_rays
    gt = gt.to(pred.dtype)
    if logits is not None:
        logp, log1mp = -F.softplus(-logits), -F.softplus(logits)
    else:
        logp, log1mp = torch.log(pred + 1e-8), torch.log(1.0 - pred + 1e-8)
    cost_ce = (-psum(gt.T @ logp, mesh) - psum((1.0 - gt).T @ log1mp, mesh)) / n
    tp = psum(gt.T @ pred, mesh)
    fp = psum(pred.sum(0), mesh)[None, :] - tp
    fn = psum(gt.sum(0), mesh)[:, None] - tp
    return cost_ce, 1.0 - tp / (tp + fp + fn + 1e-6)


def column_mean(pred: torch.Tensor, mesh: Optional[DataMesh] = None,
                n_rays: Optional[int] = None) -> torch.Tensor:
    """pred's mean over the rays of every rank [K]: this rank's mean weighted
    by its share of the n_rays, summed (an empty share adds zeros)."""
    if mesh is None:
        return pred.mean(0)
    n = pred.shape[0]
    return psum(pred.mean(0) * (n / n_rays) if n else pred.sum(0), mesh)


def ins_criterion_pair(pred_coarse: torch.Tensor, pred_fine: torch.Tensor,
                       gt_labels: torch.Tensor, ins_num: int,
                       logits_coarse: Optional[torch.Tensor] = None,
                       logits_fine: Optional[torch.Tensor] = None,
                       mesh: Optional[DataMesh] = None, n_rays: Optional[int] = None):
    """Coarse and fine instance losses. Under a mesh, the rays are this
    rank's share of n_rays."""
    gt, row_valid, valid_num = build_gt_onehot(gt_labels, ins_num, mesh)
    stats = [(*cost_matrices(pred, gt, logits, mesh, n_rays), column_mean(pred, mesh, n_rays))
             for pred, logits in ((pred_coarse, logits_coarse), (pred_fine, logits_fine))]
    return ins_loss_from_stats(stats, row_valid, valid_num, ins_num)


def ins_loss_from_stats(stats, row_valid, valid_num, ins_num: int):
    """The matched losses from (summed) statistics: stats holds one
    (cost_ce, cost_siou, column mean of pred) per field. All assignments come
    from one copy of the [len(stats), K, K] costs to the host and one solver
    call each there; returns one InsLoss per field. The copy of the costs is
    the one wait for the device: on CUDA the assignments go back without
    one."""
    cost = torch.stack([ce + siou for ce, siou, _ in stats]).detach()
    cost = torch.where(row_valid[None, :, None], cost, 0.0)
    # the spans name the copy (it waits for the queued forward) and the solve
    # in a torch.profiler trace (tools/trace_step.py; the benchmark reads them
    # by these names)
    with span("lap.copy_to_host"):
        host = torch.cat([cost.reshape(-1).double(), valid_num.double()[None]]).cpu().numpy()
    nv = int(host[-1])
    costs = host[:-1].reshape(len(stats), ins_num, ins_num)
    with span("lap.solve"):
        col4rows = torch.from_numpy(np.stack([lap_square(c, nv) for c in costs]))
    if cost.device.type == "cuda":
        # from pinned memory the copy back is queued without a wait (torch's
        # pinned pool reuses the block only once the copy has run)
        col4rows = col4rows.pin_memory()
    col4rows = col4rows.to(cost.device, non_blocking=True)
    return tuple(_matched_loss(ce, siou, col_mean, row_valid, valid_num, ins_num, c4r)
                 for (ce, siou, col_mean), c4r in zip(stats, col4rows))


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
