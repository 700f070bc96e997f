"""LR schedule and optimizer (port of dmnerf_tpu/train/schedule.py and
train/step.py::make_optimizer): Adam(b=0.9/0.999, eps=1e-8) with continuous
exponential decay, lr(i) = lrate * 0.1^(i / (lrate_decay * 1000)) applied at
step i with no lag (reference train_dmsr.py:68-72; PARITY.md, "LR decay
timing")."""

from __future__ import annotations

from typing import Dict

import torch
from torch.optim.lr_scheduler import LambdaLR


def exp_decay_factor(lrate_decay_k: int):
    """step -> lr(step) / lrate."""
    steps = lrate_decay_k * 1000
    return lambda step: 0.1 ** (step / steps)


def make_optimizer(params: Dict[str, torch.nn.Module], lrate: float, lrate_decay_k: int,
                   start_step: int = 0):
    """(Adam over the coarse then the fine parameters, LambdaLR) with the lr
    of step `start_step` set; call sched.step() after every optimizer step."""
    opt = torch.optim.Adam([p for k in ("coarse", "fine") for p in params[k].parameters()],
                           lr=lrate, betas=(0.9, 0.999), eps=1e-8)
    return opt, make_scheduler(opt, lrate, lrate_decay_k, start_step)


def make_scheduler(opt: torch.optim.Optimizer, lrate: float, lrate_decay_k: int,
                   start_step: int = 0) -> LambdaLR:
    for group in opt.param_groups:
        group["initial_lr"] = lrate
    return LambdaLR(opt, exp_decay_factor(lrate_decay_k), last_epoch=start_step - 1)
