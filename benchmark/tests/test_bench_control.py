"""The comparison's control on the card: the reference computed in fp8 in
the program's place must come out not correct, and the program itself
correct, against each cell's limits, on three seeds, each cell at its own
size (a render seed takes ~45 s, a train seed ~3 s).

    python -m pytest benchmark/tests/test_bench_control.py -q     (on the card)
"""

import pytest
import torch

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dmsr-train", "replica-train", "dmsr-render",
                                  "replica-render"])
def test_control_fails_and_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels have no CPU mode")
    cell = harness.load_cell(name)
    drv = harness.driver(cell.traffic)
    for seed in (7000000001, 7000000002, 7000000003):
        res = drv.readings(cell, seed, torch.device("cuda:0"))
        ok, checks = harness.judge(res["program"], cell.limits)
        assert ok, (seed, checks)
        ok, checks = harness.judge(res["control_fp8"], cell.limits)
        assert not ok, (seed, checks)
