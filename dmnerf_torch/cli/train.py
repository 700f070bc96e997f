"""Training CLI of the port: `python -m dmnerf_torch.cli.train --config ...`

Mirrors dmnerf_tpu/cli/train.py: flags and config files are the JAX
package's (copied into dmnerf_torch.config), the dataset follows --datadir and the pixel
sampler (full vs 30%-labeled crop) follows the dataset. Adds --device
(default cuda; a CUDA device that is not there is an error, never a silent
move to the CPU). --pallas_train (default True) runs the field through the
CUDA kernels K1/K2; --pallas_train False is the plain autograd path.

Several cards: launch under torchrun, one process per card,

    python -m torch.distributed.run --nproc_per_node R -m dmnerf_torch.cli.train --config ...

and each step's rays split over the R ranks (parallel/mesh.py; NCCL, or
gloo with --device cpu). --device cuda is cuda:{LOCAL_RANK}; --data_devices
0 (the default) means all launched ranks, and any other value must equal
R. Rank 0 prints and writes metrics.jsonl, the checkpoints, the in-train
evals and the --profile_steps trace. Without torchrun the run is one
process on one device, as before.
"""

from __future__ import annotations

import argparse

import torch

from dmnerf_torch.cli.test import launch_mesh, resolve_device
from dmnerf_torch.config import initial
from dmnerf_torch.data.base import load_dataset
from dmnerf_torch.parallel.mesh import close_mesh


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
    mesh = launch_mesh(args, device)
    state = train(args, scene, device=mesh.device if mesh else device, mesh=mesh)
    close_mesh(mesh)
    return state


if __name__ == "__main__":
    main()
