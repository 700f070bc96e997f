"""The formulations of the train step that wait for the device, which the
port's sync-free ones are held to bit for bit: torch.cumprod's autograd
(its backward tests its input for zeros on the host), torch.bincount (it
reads the labels' min and max on the host) and the assignments' copy back
from pageable memory. Imports no jax: the card tests use them too."""

import numpy as np
import torch


def cumprod_alpha_weights(sigma, dists):
    """core/rendering.py::alpha_weights on torch.cumprod's own autograd."""
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1),
        dim=-1)[..., :-1]
    return alpha * trans


def bincount_gt_onehot(gt_labels, ins_num, mesh=None):
    """losses/instance.py::build_gt_onehot with the presence from
    torch.bincount (no mesh)."""
    assert mesh is None
    labels = gt_labels.long()
    presence = torch.bincount(labels, minlength=ins_num)[:ins_num] > 0
    valid_num = presence.sum()
    rank = torch.cumsum(presence.long(), 0) - 1
    gt = torch.nn.functional.one_hot(rank[labels], ins_num).float()
    return gt, torch.arange(ins_num, device=labels.device) < valid_num, valid_num


def pageable_ins_loss_from_stats(stats, row_valid, valid_num, ins_num):
    """losses/instance.py::ins_loss_from_stats with the assignments copied
    back from pageable memory."""
    from dmnerf_torch.losses import instance
    from dmnerf_torch.ops.lap import lap_square

    cost = torch.stack([ce + siou for ce, siou, _ in stats]).detach()
    cost = torch.where(row_valid[None, :, None], cost, 0.0)
    host = torch.cat([cost.reshape(-1).double(), valid_num.double()[None]]).cpu().numpy()
    nv = int(host[-1])
    costs = host[:-1].reshape(len(stats), ins_num, ins_num)
    col4rows = torch.from_numpy(np.stack([lap_square(c, nv) for c in costs])).to(cost.device)
    return tuple(instance._matched_loss(ce, siou, col_mean, row_valid, valid_num, ins_num, c4r)
                 for (ce, siou, col_mean), c4r in zip(stats, col4rows))


def gt_label_set(kind, ins_num, n=96, seed=3):
    """n labels in [0, ins_num): every label present, labels with gaps (every
    third id, and the last), a single label, or none."""
    rng = np.random.default_rng(seed)
    if kind == "all":
        ids = np.arange(ins_num)
    elif kind == "gaps":
        ids = np.append(np.arange(1, ins_num - 1, 3), ins_num - 1)
    elif kind == "single":
        ids = np.asarray([ins_num // 2])
    else:
        return torch.zeros(0, dtype=torch.long)
    labels = np.concatenate([ids, rng.choice(ids, n - len(ids))]) if n > len(ids) else ids
    return torch.from_numpy(rng.permutation(labels))
