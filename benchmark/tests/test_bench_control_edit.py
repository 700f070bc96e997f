"""The comparison of dmsr-edit on the card: the reference computed in fp8 in
the program's place and each planted fault (the object left where it was,
manipulate_chunk's second exchange skipped, the first chunk's labels moved
one slot) must come out not correct, and the program itself correct,
against the cell's limits, on three seeds (~80 s a seed).

    python -m pytest benchmark/tests/test_bench_control_edit.py -q     (on the card)
"""

import pytest
import torch

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7000000001, 7000000002, 7000000003])
def test_control_and_faults_fail_and_program_passes(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels have no CPU mode")
    cell = harness.load_cell("dmsr-edit")
    res = harness.driver(cell.traffic).readings(cell, seed, torch.device("cuda:0"))
    ok, checks = harness.judge(res["program"], cell.limits)
    assert ok, checks
    for key in ("control_fp8", "fault_unmoved", "fault_second_exchange", "fault_answer"):
        ok, checks = harness.judge(res[key], cell.limits)
        assert not ok, (key, checks)
