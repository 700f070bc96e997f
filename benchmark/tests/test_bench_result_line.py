"""The shape of a run's last line, the checks printed beside their limits,
and the runs that must end without a result."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_tiny import run_tiny, tiny_cell

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name", ["dmsr-train", "dmsr-render"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line(name, trace, capsys):
    cell = tiny_cell(name, precision="f32")
    rc, res, err = run_tiny(cell, capsys, trace=trace)
    assert rc == 0
    keys = list(res)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
    assert keys[-1] == "checks" and set(res["checks"]) == set(cell.limits)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    tail = err.strip().splitlines()[-len(cell.limits):]
    assert all(line.startswith("check ") and "(limit " in line for line in tail)
    # the f32 program computes what the reference does: every check passes
    assert res["correct"] is True
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in cell.per_layer}
        assert set(res["metrics"]) <= names
    else:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
        for m in res["metrics"].values():
            assert set(m) == {"value", "unit"} and m["value"] > 0


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dmsr-train",
                           "--seed", "5000000001", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(REPO)
    assert p.returncode != 0 and not p.stdout.strip()


def test_benchmark_alone_is_no_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "{" not in p.stdout
