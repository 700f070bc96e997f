"""A cell of the benchmark at a toy size for the CPU tests: the flagship
configuration's layout with narrow fields, few rays and small views (the
program runs its plain PyTorch paths on the CPU)."""

import torch

from benchmark import harness


def tiny_cell(name: str, precision: str = "bf16", limits=None) -> harness.Cell:
    cell = harness.load_cell(name)
    cfg = dict(cell.cfg, netdepth=6, netwidth=32, multires=4, multires_views=2, N_train=64,
               N_samples=8, N_importance=8, N_test=96, H=12, W=16, ins_num=5, train_views=4,
               precision=precision)
    traffic = dict(cell.traffic, poses=4) if "poses" in cell.traffic else cell.traffic
    return harness.Cell(name, cfg, traffic, cell.limits if limits is None else limits,
                        cell.per_layer)


def run_tiny(cell, capsys, trace=False, seed=2**31 + 11):
    """Run the cell on the CPU for half a second; (exit code, result, stderr)."""
    import json
    import time

    from benchmark import run

    rc = run.run_cell(cell, seed, 0.5, trace, torch.device("cpu"), "cpu", {},
                      t_start=time.perf_counter())
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err
