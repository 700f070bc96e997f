"""Trace the port's train step with torch.profiler and print its device time
by category and by kernel, its device busy share and the split of its host
time (port of tools/trace_step.py).

    python -m dmnerf_torch.tools.trace_step [--steps 50] [--top 40] [--out DIR]
    python -m dmnerf_torch.tools.trace_step --parse_only --out DIR [--steps N]

Capture: bench.py's train workload (tools/bench_step_anatomy.py:39-76: 3072
rays, 64+128 samples, two 8x256 fields, K=32 on the subdivided boxroom
labels, penalizer and perturb on, bf16, the kernels K1/K2) on the card; one
dispatch of --steps steps outside the trace (it builds the kernels), then one
traced dispatch of --steps steps into --out.

--parse_only reads the newest *.pt.trace.json[.gz] under --out, which is also
what `cli.train --profile_steps N` writes into {logdir}/profile (there pass
--steps N x scan_steps). It prints:
- the device time (the kernel, memcpy and memset events), in ms and ms/step;
- the same by category: the port's kernels by their launch names
  (field_forward, field_backward, render_field_*; an f32 build adds _f32),
  then gemm, sort, reduce, elementwise and copy, then other;
- the top --top kernels by name with their launch counts;
- the device's busy share of the traced window (the union of the device
  events over the span of all events);
- the host's time: in CUDA API calls that launch, that copy or wait, and
  the rest of the API; in torch ops outside the API; outside both (Python,
  the host LAP's solve); the LAP's spans (losses/instance.py's
  `lap.copy_to_host` and `lap.solve` annotations); and the copies and waits
  by the torch ops and annotations around each, outermost first (which op
  made the host wait for the device).
A trace taken on the card that holds no device events is an error (exit 1).
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
API_CATS = ("cuda_runtime", "cuda_driver")
LAP_SPANS = ("lap.copy_to_host", "lap.solve")
CATEGORIES = ("field_forward", "field_forward_f32", "field_backward", "field_backward_f32",
              "render_field_sigma", "render_field_sigma_f32", "render_field_all",
              "render_field_all_f32", "render_field_ins", "render_field_ins_f32",
              "gemm", "sort", "reduce", "elementwise", "copy", "other")
# the CUDA kernels of each launch of the port's wrappers (kernels/csrc): K1
# one, K2 a per-tile pass, the dW GEMM and two reductions, K3/K4/K5 one
# composite_kernel each, told apart by its Heads argument; the build by the
# template's type (float: the f32 build). K2's reductions are not templated:
# they count under field_backward in either build.
_FIELD = {"field_forward_kernel": "field_forward", "field_bwd_tile_kernel": "field_backward",
          "dw_partial_kernel": "field_backward", "reduce_splits_kernel": "field_backward"}
# the kernel that marks one launch of each wrapper
_LAUNCH_MARK = {"field_forward": "field_forward_kernel", "field_backward": "field_bwd_tile_kernel"}
_HEADS = {"0": "all", "H_ALL": "all", "1": "ins", "H_INS": "ins", "2": "sigma",
          "H_SIGMA": "sigma"}
_GENERIC = (("gemm", ("gemm", "gemv", "xmma", "nvjet", "cutlass", "cublas")),
            ("sort", ("sort",)),
            ("reduce", ("reduce", "scan")),
            ("copy", ("copy",)),
            ("elementwise", ("elementwise", "index", "scatter", "gather", "fill")))


def _f32(name, dtype):
    return name + ("_f32" if re.search(r"\bfloat\b", dtype) else "")


def categorize(name: str, cat: str = "kernel") -> str:
    """The category of one device event."""
    if cat != "kernel":
        return "copy"
    for mark, port in _FIELD.items():
        if mark in name:
            m = re.search(mark + r"<([^>]*)>", name)
            return _f32(port, m.group(1) if m else "")
    m = re.search(r"composite_kernel<([^,>]+),([^>]*)>", name)
    if m:
        head = _HEADS.get(re.findall(r"\w+", m.group(2))[-1], "all")
        return _f32(f"render_field_{head}", m.group(1))
    low = name.lower()
    for category, keys in _GENERIC:
        if any(k in low for k in keys):
            return category
    return "other"


def _merge(intervals):
    """Sorted, disjoint [start, end) intervals covering the given ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _intervals(events):
    return _merge((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events)


def _length(merged):
    return sum(b - a for a, b in merged)


def _intersect(x, y):
    """The intersection of two merged interval lists, merged."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append([a, b])
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def _enclosing(containers, calls):
    """{the container events around each call on its thread, outermost
    first, joined by " > " (or "(outside any op)"): [ms, calls]}."""
    by_thread = defaultdict(list)
    for kind, es in ((0, containers), (1, calls)):
        for e in es:
            ts = float(e["ts"])
            by_thread[(e.get("pid"), e.get("tid"))].append(
                (ts, kind, ts + float(e["dur"]), e.get("name", "?")))
    out = defaultdict(lambda: [0.0, 0])
    for items in by_thread.values():
        stack = []                      # (end, name) of the open containers
        # at one start time containers come first, the outer (longer) first
        for ts, kind, end, name in sorted(items, key=lambda x: (x[0], x[1], -x[2])):
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if kind == 0:
                stack.append((end, name))
            else:
                acc = out[" > ".join(n for _, n in stack) or "(outside any op)"]
                acc[0] += (end - ts) / 1e3
                acc[1] += 1
    return out


def newest_trace(out_dir: str) -> str:
    files = [p for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for p in glob.glob(os.path.join(out_dir, "**", pat), recursive=True)]
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {out_dir}")
    return max(files, key=os.path.getmtime)


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def summarize(trace: dict) -> dict:
    """The numbers the report prints, from a Chrome trace as torch.profiler
    writes it (times in ms)."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e and "dur" in e]
    span = _intervals(events)
    window = (span[-1][1] - span[0][0]) / 1e3 if span else 0.0
    dev = [e for e in events if e.get("cat", "").lower() in DEVICE_CATS]
    by_name = defaultdict(lambda: [0.0, 0])
    by_cat = defaultdict(lambda: [0.0, 0])
    launches = defaultdict(int)
    for e in dev:
        ms = float(e["dur"]) / 1e3
        name = e.get("name", "?")
        category = categorize(name, e["cat"].lower())
        for acc in (by_name[name], by_cat[category]):
            acc[0] += ms
            acc[1] += 1
        for port, mark in _LAUNCH_MARK.items():
            if category.startswith(port) and mark in name:
                launches[category] += 1
        if category.startswith("render_field"):
            launches[category] += 1
    busy = _length(_intervals(dev)) / 1e3
    api = [e for e in events if e.get("cat", "").lower() in API_CATS]
    api_iv = _intervals(api)
    ops_iv = _intervals(e for e in events if e.get("cat", "").lower() == "cpu_op")
    host = {"launch": [0.0, 0], "copy or wait": [0.0, 0], "other API": [0.0, 0]}
    waits = []
    for e in api:
        n = e.get("name", "")
        key = ("launch" if "Launch" in n else
               "copy or wait" if ("Memcpy" in n or "Synchronize" in n) else "other API")
        host[key][0] += float(e["dur"]) / 1e3
        host[key][1] += 1
        if key == "copy or wait":
            waits.append(e)
    containers = [e for e in events if e.get("cat", "").lower() in ("cpu_op", "user_annotation")]
    ops_only = (_length(ops_iv) - _length(_intersect(ops_iv, api_iv))) / 1e3
    host["torch ops outside the API"] = [ops_only, None]
    host["outside torch ops and the API"] = [
        window - (_length(_merge(ops_iv + api_iv))) / 1e3, None]
    lap = {n: [0.0, 0] for n in LAP_SPANS}
    for e in events:
        if e.get("name") in lap and e.get("cat", "").lower() == "user_annotation":
            lap[e["name"]][0] += float(e["dur"]) / 1e3
            lap[e["name"]][1] += 1
    return {"window_ms": window, "device_ms": sum(v[0] for v in by_cat.values()),
            "busy_ms": busy, "busy_share": busy / window if window else 0.0,
            "by_category": {c: tuple(by_cat[c]) for c in CATEGORIES if c in by_cat},
            "by_name": {k: tuple(v) for k, v in by_name.items()},
            "launches": dict(launches), "host": {k: tuple(v) for k, v in host.items()},
            "lap": {k: tuple(v) for k, v in lap.items()},
            "waits_by_op": {k: tuple(v) for k, v in sorted(
                _enclosing(containers, waits).items(), key=lambda kv: -kv[1][0])},
            "on_card": bool(trace.get("deviceProperties")) or bool(api) or bool(dev)}


def report(path: str, steps: int, top: int) -> int:
    """Print the tables of the trace at `path`; 1 if a trace taken on the
    card holds no device events, else 0."""
    s = summarize(load_trace(path))
    print(f"trace {path}: window {s['window_ms']:.3f} ms ({s['window_ms'] / steps:.3f} ms/step "
          f"over {steps} steps)")
    if not s["by_category"]:
        if s["on_card"]:
            print("error: a trace taken on the card holds no device events", file=sys.stderr)
            return 1
        print("device: none (a trace taken on the CPU); device time not measured")
    else:
        print(f"device time {s['device_ms']:.3f} ms, {s['device_ms'] / steps:.3f} ms/step; "
              f"busy {s['busy_ms']:.3f} ms, {100 * s['busy_share']:.1f}% of the window "
              f"(idle {100 * (1 - s['busy_share']):.1f}%)")
        print("\n== device time by category (ms, ms/step, events, share) ==")
        for cat, (ms, n) in s["by_category"].items():
            print(f"  {cat:22s} {ms:10.3f} {ms / steps:9.3f} {n:7d} "
                  f"{100 * ms / s['device_ms']:6.1f}%")
        print(f"  launches of the port's kernels: {s['launches']}")
        print(f"\n== top {top} kernels (ms, ms/step, launches) ==")
        for name, (ms, n) in sorted(s["by_name"].items(), key=lambda kv: -kv[1][0])[:top]:
            print(f"  {ms:10.3f} {ms / steps:9.3f} {n:7d}  {name[:110]}")
    print("\n== host time (ms, ms/step, calls) ==")
    for key, (ms, n) in s["host"].items():
        print(f"  {key:30s} {ms:10.3f} {ms / steps:9.3f} {'' if n is None else n:>7}")
    for key, (ms, n) in s["lap"].items():
        print(f"  {key:30s} {ms:10.3f} {ms / steps:9.3f} {n:7d}")
    print("\n== copies and waits by the ops around them, outermost first "
          "(ms, ms/step, calls) ==")
    for key, (ms, n) in list(s["waits_by_op"].items())[:10]:
        print(f"  {ms:10.3f} {ms / steps:9.3f} {n:7d}  {key[-150:]}")
    return 0


def capture(out_dir: str, steps: int, device: str) -> None:
    """bench.py's train workload: one dispatch of `steps` steps outside the
    trace, then one traced dispatch into out_dir."""
    import numpy as np
    import torch

    from dmnerf_torch.config import default_config
    from dmnerf_torch.data.synthetic import make_scene
    from dmnerf_torch.models.fields import FieldConfig
    from dmnerf_torch.train.step import create_train_state, make_train_scan_step, scene_arrays
    from dmnerf_torch.utils.profiling import trace

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    args = default_config(
        N_train=3072, N_samples=64, N_importance=128, near=1.0, far=12.0, perturb=1.0,
        penalize=True, tolerance=0.05, deta_w=0.05, lrate=5e-4, lrate_decay=500,
        precision="bf16", netdepth=8, netwidth=256, multires=10, multires_views=4,
        pallas_train=True, ins_num=32)
    scene = make_scene(H=128, W=128, n_train=4, n_test=4)
    yy, xx = np.meshgrid(np.arange(scene.H), np.arange(scene.W), indexing="ij")
    sub = ((yy * 2) // scene.H) * 4 + ((xx * 4) // scene.W)     # 8 labels per object
    scene.gt_labels = (scene.gt_labels * 8 + sub[None]).astype(scene.gt_labels.dtype)
    cfg = FieldConfig.from_args(args)
    state = create_train_state(0, cfg, args.lrate, args.lrate_decay, device=dev)
    step = make_train_scan_step(args, cfg)
    arrs = scene_arrays(scene, dev)
    i_train = np.asarray(scene.i_train)
    step(state, arrs, 1, i_train, steps)                 # builds the kernels
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with trace(out_dir, dev):
        step(state, arrs, 1, i_train, steps)
    print(f"trace captured to {out_dir}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="step_trace", help="trace directory")
    p.add_argument("--steps", type=int, default=50, help="steps in the traced window")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--parse_only", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if not a.parse_only:
        capture(a.out, a.steps, a.device)
    return report(newest_trace(a.out), a.steps, a.top)


if __name__ == "__main__":
    sys.exit(main())
