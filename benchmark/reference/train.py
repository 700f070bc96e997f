"""One DM-NeRF training step in plain float32 PyTorch, and Adam.

The step (the authors' train loop): draw one training view and N_train of its
pixels, render them coarse then fine with stratified jitter and random
importance samples, and sum
- the photometric loss, the mean squared error of the coarse and of the fine
  colour;
- the instance loss of each pass: the labels present in the batch, in
  ascending order, one-hot into the first slots of a [N, ins_num] target;
  cost = mean binary cross-entropy (from the logits) + 1 - soft IoU between
  every target slot and every predicted slot; the Hungarian matching of the
  valid slots (scipy's linear_sum_assignment); the mean matched cross-entropy,
  the mean prediction over the slots no target took, and the mean matched
  1 - soft IoU;
- the emptiness penalizer of each pass: a Gaussian (deta_w) around the
  detached depth; before depth - tolerance the instance channels are pushed
  toward "air", within the band the air channel toward 0.
Then one Adam step (0.9, 0.999, 1e-8) at lr = lrate * 0.1^(step / (lrate_decay
* 1000)).

The randomness is drawn as the authors' loop is seeded per step: for step s,
SeedSequence([base_seed, s]) gives the view (uniform over the training views)
and the seed of a torch.Generator on the device, from which the pixels (a
random permutation's first N_train), the jitter [N, N_samples] and the
importance uniforms [N, N_importance] are drawn in that order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from benchmark.reference.render import (composite, importance, linear_depths, pixel_dirs,
                                        run_field)


def step_draws(base_seed: int, step: int, n_views: int, device):
    """(view position, torch.Generator on device) of one step."""
    s_view, s_gen = np.random.SeedSequence([int(base_seed), int(step)]).generate_state(2, np.uint64)
    view = int(np.random.default_rng(int(s_view)).integers(n_views))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(s_gen))
    return view, gen


def assign(cost: np.ndarray, n_valid: int) -> np.ndarray:
    """col of each row: the valid rows matched at least cost, the rest of the
    rows take the free columns in ascending order."""
    n = cost.shape[0]
    col = np.empty(n, np.int64)
    rows, cols = linear_sum_assignment(np.nan_to_num(cost[:n_valid], nan=0.0))
    col[rows] = cols
    col[n_valid:] = np.setdiff1d(np.arange(n), cols)[:n - n_valid]
    return col


def instance_loss(pass_outs, labels: torch.Tensor, ins_num: int):
    """The matched instance losses of the coarse and fine passes (one
    matching each)."""
    present = torch.bincount(labels, minlength=ins_num)[:ins_num] > 0
    slot = torch.cumsum(present.long(), 0) - 1
    n_valid = int(present.sum())
    gt = F.one_hot(slot[labels], ins_num).float()
    n = labels.shape[0]
    losses = []
    for out in pass_outs:
        pred, logits = out["ins"], out["logits"]
        ce = (-(gt.T @ -F.softplus(-logits)) - ((1.0 - gt).T @ -F.softplus(logits))) / n
        tp = gt.T @ pred
        fp = pred.sum(0)[None, :] - tp
        fn = gt.sum(0)[:, None] - tp
        siou = 1.0 - tp / (tp + fp + fn + 1e-6)
        col = torch.from_numpy(assign((ce + siou).detach().double().cpu().numpy(), n_valid))
        col = col.to(labels.device)
        rows = torch.arange(n_valid, device=labels.device)
        c = col[:n_valid]
        valid_ce = ce[rows, c].sum() / max(n_valid, 1)
        valid_siou = siou[rows, c].sum() / max(n_valid, 1)
        taken = torch.zeros(ins_num, dtype=torch.bool, device=labels.device)
        taken[c] = True
        free = ~taken
        invalid = pred.mean(0)[free].sum() / free.sum() if bool(free.any()) else pred.sum() * 0
        losses.append(valid_ce + invalid + valid_siou)
    return losses


def penalizer(raw, z, depth, rays_d, tolerance: float, deta_w: float):
    norm = torch.linalg.norm(rays_d, dim=-1)[:, None]
    depth = depth.detach()[:, None]
    p = z * norm
    gauss = (torch.exp(-((depth * norm - p) ** 2) / (2.0 * deta_w ** 2))
             / (0.4 * math.sqrt(2.0 * math.pi)) + 1e-8)
    before = (p < (depth - tolerance) * norm).float()
    after = (p > (depth + tolerance) * norm).float()
    middle = 1.0 - before - after
    ins = raw[..., 4:]
    target = torch.zeros_like(ins)
    target[..., -1] = 1.0
    bce_all = (F.softplus(ins) - target * ins).sum(-1) / ins.shape[-1]
    bce_air = F.softplus(ins[..., -1])
    l_before = (bce_all * (1.0 - gauss) * before).sum() / torch.clamp(before.sum(), min=1e-8)
    l_middle = (bce_air * gauss * middle).sum() / torch.clamp(middle.sum(), min=1e-8)
    return l_before + l_middle


class Trainer:
    """The reference's two fields and their Adam state; `step()` takes one
    training step on the scene and returns its loss and gradients.

    quantize: None (float32), "bf16" or "fp8": the rounding of each product's
    operands (reference/field.py).
    keep_rays: the share of the batch's rays whose losses count (1.0; a
    fault check takes 0.5, the mean over the rest)."""

    def __init__(self, cfg: dict, weights: dict, scene, base_seed: int,
                 quantize=None, keep_rays: float = 1.0):
        self.cfg, self.scene, self.base_seed = cfg, scene, int(base_seed)
        self.quantize, self.keep_rays = quantize, keep_rays
        self.params = {k: {n: t.detach().clone().requires_grad_(True) for n, t in w.items()}
                       for k, w in weights.items()}
        self.m = {k: {n: torch.zeros_like(t) for n, t in w.items()} for k, w in self.params.items()}
        self.v = {k: {n: torch.zeros_like(t) for n, t in w.items()} for k, w in self.params.items()}
        self.t = 0

    def loss(self, step: int):
        cfg, sc = self.cfg, self.scene
        n_train, n_s, n_i = int(cfg["N_train"]), int(cfg["N_samples"]), int(cfg["N_importance"])
        images, labels, poses, K = sc["images"], sc["labels"], sc["poses"], sc["K"]
        dev = images.device
        H, W = images.shape[1:3]
        view, gen = step_draws(self.base_seed, step, images.shape[0], dev)
        pix = torch.randperm(H * W, generator=gen, device=dev)[:n_train]
        c2w = poses[view]
        dirs = pixel_dirs((pix % W).float(), torch.div(pix, W, rounding_mode="floor").float(), K)
        rays_d = dirs @ c2w[:3, :3].T
        rays_o = c2w[:3, 3].expand(rays_d.shape)
        target_c = images[view].reshape(-1, 3)[pix]
        target_i = labels[view].reshape(-1)[pix]

        z = linear_depths(n_train, float(cfg["near"]), float(cfg["far"]), n_s, dev)
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], -1)
        lower = torch.cat([z[:, :1], mids], -1)
        z = lower + (upper - lower) * torch.rand(z.shape, generator=gen, device=dev)
        raw_c = run_field(self.params["coarse"], cfg, rays_o, rays_d, z, self.quantize)
        out_c = composite(raw_c, z, rays_d)
        u = torch.rand((n_train, n_i), generator=gen, device=dev)
        z_f, _ = torch.sort(torch.cat([z, importance(z, out_c["weights"], n_i, u)], -1), -1)
        raw_f = run_field(self.params["fine"], cfg, rays_o, rays_d, z_f, self.quantize)
        out_f = composite(raw_f, z_f, rays_d)

        keep = slice(0, int(n_train * self.keep_rays))
        rgb = sum(torch.mean((o["rgb"][keep] - target_c[keep]) ** 2) for o in (out_c, out_f))
        total = rgb
        for out, raw, zz in ((out_c, raw_c, z), (out_f, raw_f, z_f)):
            total = total + penalizer(raw[keep], zz[keep], out["depth"][keep], rays_d[keep],
                                      float(cfg["tolerance"]), float(cfg["deta_w"]))
        sub = [{k: v[keep] for k, v in o.items()} for o in (out_c, out_f)]
        for l_ins in instance_loss(sub, target_i[keep], int(cfg["ins_num"])):
            total = total + l_ins
        return total, rgb

    def step(self, step: int):
        """One step; returns (loss, photometric loss, {field: {name: gradient}})."""
        leaves = [(k, n, p) for k, w in self.params.items() for n, p in w.items()]
        total, rgb = self.loss(step)
        grads = torch.autograd.grad(total, [p for _, _, p in leaves])
        self.t += 1
        lr = float(self.cfg["lrate"]) * 0.1 ** (step / (float(self.cfg["lrate_decay"]) * 1000))
        b1, b2, eps = 0.9, 0.999, 1e-8
        out = {k: {} for k in self.params}
        with torch.no_grad():
            for (k, n, p), g in zip(leaves, grads):
                out[k][n] = g
                m, v = self.m[k][n], self.v[k][n]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v / (1 - b2 ** self.t)).sqrt() + eps
                p.sub_(lr / (1 - b1 ** self.t) * m / denom)
        return float(total.detach()), float(rgb.detach()), out
