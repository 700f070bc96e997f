"""Training CLI of the port: `python -m dmnerf_torch.cli.train --config ...`

Mirrors dmnerf_tpu/cli/train.py: flags and config files are the JAX
package's (copied into dmnerf_torch.config), the dataset follows --datadir and the pixel
sampler (full vs 30%-labeled crop) follows the dataset. Adds --device
(default cuda; a CUDA device that is not there is an error, never a silent
move to the CPU). One device: multi-GPU is not ported yet (ROADMAP.md queue
1, item 3). --pallas_train (default True) runs the field through the CUDA
kernels K1/K2; --pallas_train False is the plain autograd path.
"""

from __future__ import annotations

import argparse

import torch

from dmnerf_torch.cli.test import resolve_device
from dmnerf_torch.config import initial
from dmnerf_torch.data.base import load_dataset


def load(argv=None):
    """Parse the flags (creating the run's log dir) and load the scene:
    (args, scene, device)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    ns, rest = pre.parse_known_args(argv)
    device = resolve_device(ns.device)
    args = initial(rest)
    if getattr(args, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True)
    args.is_train = True
    scene = load_dataset(args)
    print(f"Loaded {args.datadir}: {len(scene.images)} images "
          f"{scene.H}x{scene.W}, ins_num={scene.ins_num}; device {device}")
    return args, scene, device


def main(argv=None):
    args, scene, device = load(argv)
    from dmnerf_torch.train.loop import train
    return train(args, scene, device=device)


if __name__ == "__main__":
    main()
