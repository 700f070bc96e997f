"""Run one cell of the benchmark of dmnerf_torch once, on the machine's
NVIDIA card, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (BENCHMARK.json's `workloads`) names a configuration and a traffic
mix; both, the limits of its comparison and its per-layer readers are found
by name under benchmark/. The traffic's `driver` (drivers/<name>.py) sets the
program up from the seed, warms every shape the window uses, measures for
S seconds, and checks what the timed path produced against the plain
reference. --trace 1 times the first half of the window untraced and runs
torch.profiler over the second half, and reports the per-layer metrics.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# every build and kernel cache of the run stays inside the checkout, at
# fixed paths, so that only a checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "bench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "bench_cache" / "torch_extensions")
# one process with few threads: the host side of a step is one Python thread
# and the autograd engine's, and CPU thread pools would only contend with them
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from benchmark import harness

    spec = harness.load_json(REPO / "BENCHMARK.json")
    chips = {w["name"]: w for w in spec["workloads"]}[a.workload]["chips"]
    cell = harness.load_cell(a.workload, spec)
    import torch

    torch.set_num_threads(1)
    kind = harness.check_card(chips)
    import dmnerf_torch  # noqa: F401  (the program under test; absent, the run fails here)

    marks = {"imports": time.perf_counter()}
    device = torch.device("cuda:0")
    torch.zeros(1, device=device)
    marks["CUDA context"] = time.perf_counter()
    return run_cell(cell, a.seed, a.seconds, bool(a.trace), device, kind, marks)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, kind: str, marks: dict,
             t_start: float = None) -> int:
    """Run the cell on `device` (the look for a card is the caller's) and
    print its result; the exit code."""
    import torch

    from benchmark import harness

    t_start = T_START if t_start is None else t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = harness.driver(cell.traffic).run(cell, seed, seconds, trace, device, t_start, marks)
    ok, checks = harness.judge(out["readings"], cell.limits)
    parts, prev = {}, t_start
    for name, t in marks.items():
        parts[name] = t - prev
        prev = t
    result = {"correct": bool(ok and out["failed"] == 0), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": {}, "device": {
                  "platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": int(out["peak"])}}
    if trace:
        from benchmark import trace_summary

        tr = out["ctx"]["traced"]["trace"]
        summary = trace_summary.summarize(tr)
        out["ctx"]["traced"]["summary"] = summary
        result["metrics"] = harness.per_layer_metrics(cell, out["ctx"])
        result["device"]["busy_s"] = summary["busy_ms"] / 1e3
        result["device"]["window_s"] = summary["window_ms"] / 1e3
        result["breakdown"] = trace_summary.breakdown(tr)
    else:
        result["metrics"] = {**out["metrics"],
                             "setup_s": {"value": out["setup_s"], "unit": "s"}}
    result["setup_parts_s"] = parts
    result["readings"] = {k: v for k, v in out["readings"].items() if k not in checks}
    return harness.emit(result, checks)


if __name__ == "__main__":
    sys.exit(main())
