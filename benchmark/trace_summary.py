"""Device and host time from a torch.profiler Chrome trace.

`categorize` and `summarize` are a frozen copy of the port's trace reader
(dmnerf_torch/tools/trace_step.py), so that a change to the program cannot
change how the benchmark reads its trace. `breakdown` is the benchmark's own:
the device operations that took most time, and the device's idle time by
what the host was doing meanwhile.
"""

from __future__ import annotations

import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
API_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
LAP_SPANS = ("lap.copy_to_host", "lap.solve")
CATEGORIES = ("field_forward", "field_forward_f32", "field_backward", "field_backward_f32",
              "render_field_sigma", "render_field_sigma_f32", "render_field_all",
              "render_field_all_f32", "render_field_ins", "render_field_ins_f32",
              "gemm", "sort", "reduce", "elementwise", "copy", "other")
_FIELD = {"field_forward_kernel": "field_forward", "field_bwd_tile_kernel": "field_backward",
          "dw_partial_kernel": "field_backward", "reduce_splits_kernel": "field_backward"}
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


def _complete(trace: dict):
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "ts" in e and "dur" in e]


def _cat(e) -> str:
    return e.get("cat", "").lower()


def summarize(trace: dict) -> dict:
    """Times in ms: the traced window, the device's busy time (the union of
    its events), device time by category and by kernel name with counts, and
    the host's time in CUDA API calls that launch, that copy or wait, and the
    rest; the LAP's spans."""
    events = _complete(trace)
    span = _intervals(events)
    window = (span[-1][1] - span[0][0]) / 1e3 if span else 0.0
    dev = [e for e in events if _cat(e) in DEVICE_CATS]
    by_name = defaultdict(lambda: [0.0, 0])
    by_cat = defaultdict(lambda: [0.0, 0])
    for e in dev:
        ms = float(e["dur"]) / 1e3
        name = e.get("name", "?")
        for acc in (by_name[name], by_cat[categorize(name, _cat(e))]):
            acc[0] += ms
            acc[1] += 1
    busy = _length(_intervals(dev)) / 1e3
    api = [e for e in events if _cat(e) in API_CATS]
    api_iv = _intervals(api)
    ops_iv = _intervals(e for e in events if _cat(e) == "cpu_op")
    host = {"launch": [0.0, 0], "copy or wait": [0.0, 0], "other API": [0.0, 0]}
    for e in api:
        n = e.get("name", "")
        key = ("launch" if "Launch" in n else
               "copy or wait" if ("Memcpy" in n or "Synchronize" in n) else "other API")
        host[key][0] += float(e["dur"]) / 1e3
        host[key][1] += 1
    ops_only = (_length(ops_iv) - _length(_intersect(ops_iv, api_iv))) / 1e3
    host["torch ops outside the API"] = [ops_only, None]
    host["outside torch ops and the API"] = [
        window - (_length(_merge(ops_iv + api_iv))) / 1e3, None]
    lap = {n: [0.0, 0] for n in LAP_SPANS}
    for e in events:
        if e.get("name") in lap and _cat(e) == "user_annotation":
            lap[e["name"]][0] += float(e["dur"]) / 1e3
            lap[e["name"]][1] += 1
    return {"window_ms": window, "device_ms": sum(v[0] for v in by_cat.values()),
            "busy_ms": busy, "busy_share": busy / window if window else 0.0,
            "by_category": {c: tuple(by_cat[c]) for c in CATEGORIES if c in by_cat},
            "by_name": {k: tuple(v) for k, v in by_name.items()},
            "host": {k: tuple(v) for k, v in host.items()},
            "lap": {k: tuple(v) for k, v in lap.items()}}


def _host_events(events):
    """The host's op, annotation and CUDA API events of every thread, as
    (start, end, thread, name) sorted by start, the longer first."""
    out = []
    for e in events:
        if _cat(e) in HOST_CATS + API_CATS:
            ts = float(e["ts"])
            out.append((ts, ts + float(e["dur"]), (e.get("pid"), e.get("tid")), e.get("name", "?")))
    return sorted(out, key=lambda x: (x[0], -x[1]))


def breakdown(trace: dict, top: int = 10) -> dict:
    """{"device_ops": [[name, seconds]...], "idle_gaps": [[host activity,
    seconds]...]}: the `top` device operations by time, and the device's idle
    time within the traced window summed by what the host was doing at the
    middle of each gap: of the threads with an open event there, the one
    whose innermost open event began last, named by its innermost two events
    (outer first); "python" where no thread has one open."""
    events = _complete(trace)
    s = summarize(trace)
    ops = sorted(s["by_name"].items(), key=lambda kv: -kv[1][0])[:top]
    span = _intervals(events)
    busy = _intervals(e for e in events if _cat(e) in DEVICE_CATS)
    gaps, cursor = [], span[0][0] if span else 0.0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if span and span[-1][1] > cursor:
        gaps.append((cursor, span[-1][1]))
    host = _host_events(events)
    by_what = defaultdict(float)
    i, open_ = 0, defaultdict(list)            # thread -> its open events, outer first
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            open_[host[i][2]].append(host[i])
            i += 1
        stacks = {t: [x for x in st if x[1] > mid] for t, st in open_.items()}
        open_ = defaultdict(list, {t: st for t, st in stacks.items() if st})
        label = "python"
        if open_:
            st = max(open_.values(), key=lambda st: st[-1][0])
            label = " > ".join(x[3] for x in st[-2:])
        by_what[label] += (b - a) / 1e6
    idle = sorted(by_what.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name, ms / 1e3] for name, (ms, _) in ops],
            "idle_gaps": [[what, sec] for what, sec in idle]}
