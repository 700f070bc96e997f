"""Full-CLI quality drill on the reference-format stress scenes (port of
tools/stress_drill.py).

Runs, per scene: dmnerf_torch.cli.train -> dmnerf_torch.cli.test --render ->
(DM-SR) --mani_eval, --mani_demo --mani_type rigid|deform (with --demo) and
--mesh, each in a process of its own, through the real loaders and CLIs;
then prints the summary table of the JAX tool, and the training time of
each scene (minutes, and ms/step from metrics.jsonl after its first print
window).

    python -m dmnerf_torch.tools.make_stress_scenes --out data/stress_scenes
    python -m dmnerf_torch.tools.stress_drill [--scenes dmsr,replica] \
        [--datadir DIR] [--basedir DIR] [--n_iters N] [--demo] [--device cpu]

--datadir, --basedir and --n_iters override the config's values, so a short
run in a temporary directory needs no edited config.
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CFG = {
    "dmsr": "configs/stress/dmsr_stress.txt",
    "dmsr_quality": "configs/stress/dmsr_quality.txt",
    "replica": "configs/stress/replica_stress.txt",
    "replica64": "configs/stress/replica64_stress.txt",
    "scannet": "configs/stress/scannet_stress.txt",
}


def run(cmd, capture=False):
    print("+", " ".join(cmd), flush=True)
    r = subprocess.run(cmd, cwd=ROOT, capture_output=capture, text=capture)
    if r.returncode != 0:
        if capture:
            print(r.stdout[-2000:], r.stderr[-2000:], file=sys.stderr)
        sys.exit(f"FAILED: {' '.join(cmd)}")
    return r.stdout if capture else None


def demo_ms_per_view(stdout):
    """Mean per-view wall time from manipulator_demo's '[DEMO i] x.xs' lines,
    excluding view 0 (warm-up)."""
    ts = [float(m.group(1)) for m in
          re.finditer(r"\[DEMO (?:\d+)\] ([\d.]+)s", stdout)]
    return 1e3 * float(np.mean(ts[1:])) if len(ts) > 1 else None


def results_table(ldir, prefix):
    cands = sorted(glob.glob(os.path.join(ldir, prefix + "*", "**",
                                          "test_results.txt"),
                             recursive=True))
    if not cands:
        return None
    return np.loadtxt(cands[-1])[-1]  # mean row


def train_ms_per_step(ldir, n_train):
    """Mean ms/step of the print windows of metrics.jsonl after the first,
    or None when there is no such window."""
    path = os.path.join(ldir, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    rps = [json.loads(line)["rays_per_sec"] for line in open(path)][1:]
    return float(np.mean([1e3 * n_train / r for r in rps])) if rps else None


def config_values(cfg):
    kv = dict(line.split("=", 1) for line in open(os.path.join(ROOT, cfg)) if "=" in line)
    return {k.strip(): v.strip() for k, v in kv.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="dmsr,replica,scannet")
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--demo", action="store_true",
                    help="also run mani_demo rigid+deform on the dmsr scene")
    ap.add_argument("--datadir", default=None, help="override the config's datadir")
    ap.add_argument("--basedir", default=None, help="override the config's basedir")
    ap.add_argument("--n_iters", type=int, default=None, help="override the config's n_iters")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    scenes = args.scenes.split(",")
    rows = []
    for scene in scenes:
        cfg = CFG[scene]
        kv = config_values(cfg)
        extra = ["--device", args.device]
        for key in ("datadir", "basedir", "n_iters"):
            if getattr(args, key) is not None:
                val = getattr(args, key)
                kv[key] = str(val) if key == "n_iters" else os.path.abspath(val)
                extra += [f"--{key}", kv[key]]
        ldir = os.path.join(ROOT, kv["basedir"], kv["expname"], kv["log_time"])

        def cli(module, *flags, capture=False):
            return run([sys.executable, "-u", "-m", f"dmnerf_torch.cli.{module}",
                        "--config", cfg, *flags, *extra], capture=capture)

        train_min = ms_step = None
        if not args.skip_train:
            t0 = time.perf_counter()
            cli("train")
            train_min = (time.perf_counter() - t0) / 60.0
            ms_step = train_ms_per_step(ldir, int(kv["N_train"]))
        cli("test", "--render")
        render = results_table(ldir, "render_test_")
        mani = None
        demo_ms = {}
        if scene.startswith("dmsr"):
            cli("test", "--mani_eval")
            mani = results_table(ldir, "mani_eval_")
            # mani_demo at reference scale (640x480 through the real CLI,
            # images only): rigid = a 1-object translation sequence; deform =
            # a MIXED sin-deform + rigid pair (objs_info_deform.json)
            if args.demo:
                for mt in ("rigid", "deform"):
                    out = cli("test", "--mani_demo", "--mani_type", mt, capture=True)
                    print(out[-1500:])
                    demo_ms[mt] = demo_ms_per_view(out)
            cli("test", "--mesh")
        rows.append((scene, render, mani, demo_ms, train_min, ms_step))

    lines = ["", "### Stress-scene drill results (reference formats, real CLIs)",
             "",
             "| scene | mode | PSNR | SSIM | AP50 | AP75 | AP90 | AP95 |",
             "|---|---|---|---|---|---|---|---|"]
    for scene, render, mani, demo_ms, _, _ in rows:
        for mode, t in (("render", render), ("mani_eval", mani)):
            if t is None:
                continue
            lines.append(f"| {scene} | {mode} | {t[0]:.2f} | {t[1]:.4f} | "
                         f"{t[3]:.3f} | {t[4]:.3f} | {t[7]:.3f} | {t[8]:.3f} |")
        for mt, ms in demo_ms.items():
            if ms is not None:
                lines.append(f"| {scene} | mani_demo/{mt} | "
                             f"{ms:.0f} ms/view (no GT) | | | | | |")
    for scene, _, _, _, train_min, ms_step in rows:
        if train_min is not None:
            lines.append(f"{scene}: training {train_min:.2f} min in all, "
                         + (f"{ms_step:.2f} ms/step after the first print window"
                            if ms_step is not None else "no print window after the first"))
    print("\n".join(lines))


if __name__ == "__main__":
    main()
