"""Verify resume replay-determinism from a metrics.jsonl stream (copy of
tools/check_resume_replay.py, on what dmnerf_torch.cli.train writes).

After a mid-run kill + `--resume`, the steps between the last checkpoint and
the kill point are re-executed and their i_print metric lines are APPENDED
again to metrics.jsonl (train/loop.py opens it in append mode). Training is
replay-deterministic (every step's randomness is a pure function of (seed,
step), train/step.py::step_randomness), so every duplicated step's metrics
must be IDENTICAL except the wall-clock rays/s counter.

Usage: python -m dmnerf_torch.tools.check_resume_replay LOGDIR/metrics.jsonl
Exit 0 and a summary line if every overlap matches; exit 1 with the first
mismatch otherwise.
"""

from __future__ import annotations

import json
import sys

TIMING_KEYS = {"rays_per_sec"}


def main(path: str) -> int:
    by_step: dict[int, list[dict]] = {}
    order: list[int] = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            s = int(rec["step"])
            by_step.setdefault(s, []).append(rec)
            order.append(s)
    dup = {s: rs for s, rs in by_step.items() if len(rs) > 1}
    if not dup:
        print(f"{path}: no resume overlap found "
              f"({len(order)} lines, steps {order[0]}..{order[-1]})")
        return 0
    bad = 0
    for s in sorted(dup):
        first, rest = dup[s][0], dup[s][1:]
        a = {k: v for k, v in first.items() if k not in TIMING_KEYS}
        for r in rest:
            b = {k: v for k, v in r.items() if k not in TIMING_KEYS}
            if a != b:
                bad += 1
                print(f"step {s}: REPLAY MISMATCH\n  first:  {a}\n  replay: {b}")
    lo, hi = min(dup), max(dup)
    if bad:
        print(f"{path}: {bad} mismatching steps in overlap {lo}..{hi}")
        return 1
    print(f"{path}: resume replay EXACT over {len(dup)} duplicated steps "
          f"({lo}..{hi}); all metric values identical (timing excluded)")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m dmnerf_torch.tools.check_resume_replay METRICS_JSONL")
    sys.exit(main(sys.argv[1]))
