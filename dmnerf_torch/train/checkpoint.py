"""Checkpoints as reference `.tar` files (port of
dmnerf_tpu/train/checkpoint.py, which writes orbax directories).

{log_dir}/NNNNNN.tar holds the state after exactly NNNNNN completed steps in
the reference DM-NeRF layout (models/convert.save_tar): both fields, the
step as `iteration`, and the Adam state_dict, so `--resume` continues a run
and dmnerf_torch.cli.test renders from the same file.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from dmnerf_torch.models.convert import load_tar, save_tar
from dmnerf_torch.train.schedule import make_scheduler

_TAR_RE = re.compile(r"^(\d{6,})\.tar$")


def save_checkpoint(log_dir: str, state, step: int) -> str:
    path = os.path.join(log_dir, f"{step:06d}.tar")
    tmp = f"{path}.{os.getpid()}.tmp"
    save_tar(tmp, state.params["coarse"].state_dict(), state.params["fine"].state_dict(),
             step, state.opt.state_dict())
    os.replace(tmp, path)
    return path


def latest_checkpoint(log_dir: str) -> Optional[str]:
    if not os.path.isdir(log_dir):
        return None
    steps = [(int(m.group(1)), name) for name in os.listdir(log_dir)
             if (m := _TAR_RE.match(name))]
    return os.path.join(log_dir, max(steps)[1]) if steps else None


def checkpoint_step(path: str) -> int:
    m = _TAR_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else 0


def restore_checkpoint(path: str, state, lrate: float, lrate_decay_k: int):
    """Load a `.tar` into `state` in place (fields, Adam state when the file
    has one, step, and the lr of that step); returns state."""
    coarse, fine, iteration, opt_sd = load_tar(path, with_optimizer=True)
    state.params["coarse"].load_state_dict(coarse)
    state.params["fine"].load_state_dict(fine)
    if opt_sd:
        state.opt.load_state_dict(opt_sd)
    state.sched = make_scheduler(state.opt, lrate, lrate_decay_k, iteration)
    state.step = iteration
    return state
