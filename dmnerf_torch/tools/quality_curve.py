"""Assemble the quality-convergence curve from a training run's in-train
evals (copy of tools/quality_curve.py without --record, on what
dmnerf_torch.cli.train writes).

Each i_test eval writes {ldir}/testset_{step}/test_results.txt (9 columns:
PSNR SSIM LPIPS AP50 AP75 AP80 AP85 AP90 AP95; last row = mean over views,
eval/tester.py). This collects the mean rows across steps into one markdown
table (configs/stress/dmsr_quality.txt holds out 24 views and evaluates all
of them every i_test).

  python -m dmnerf_torch.tools.quality_curve logs/dmsr_quality/full
"""

import argparse
import glob
import os
import re
import sys

import numpy as np


def collect(ldir):
    rows = []
    for d in sorted(glob.glob(os.path.join(ldir, "testset_*"))):
        m = re.search(r"testset_(\d+)$", d)
        path = os.path.join(d, "test_results.txt")
        if not m or not os.path.exists(path):
            continue
        t = np.loadtxt(path)
        rows.append((int(m.group(1)), t[-1] if t.ndim == 2 else t))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ldir")
    args = ap.parse_args(argv)
    rows = collect(args.ldir)
    if not rows:
        sys.exit(f"no testset_*/test_results.txt under {args.ldir}")
    n_views = None
    first = glob.glob(os.path.join(args.ldir, "testset_*", "test_results.txt"))
    if first:
        t = np.loadtxt(sorted(first)[0])
        n_views = (t.shape[0] - 1) if t.ndim == 2 else 1
    lines = ["",
             f"Per-eval quality curve ({args.ldir}, {n_views} held-out "
             "views, all evaluated every i_test):", "",
             "| step | PSNR | SSIM | AP50 | AP75 | AP90 | AP95 |",
             "|---|---|---|---|---|---|---|"]
    for step, r in rows:
        lines.append(f"| {step // 1000}k | {r[0]:.2f} | {r[1]:.3f} | "
                     f"{r[3]:.3f} | {r[4]:.3f} | {r[7]:.3f} | {r[8]:.3f} |")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
