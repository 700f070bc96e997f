"""Device idle and blocking host calls inside the program's spans, from a
torch.profiler Chrome trace.

A span is one of the program's record_function annotations on the host
(cat "user_annotation"); the profiler's copies of them on the device's
timeline ("gpu_user_annotation") are not read. The device is idle where no
kernel, copy or memset runs within the traced window, as trace_summary counts
it. Host spans and device events share the trace's timestamps, so an idle
interval and a span intersect on one clock.

A blocking call is a CUDA API call that returns only once the device has
reached it: any `*Synchronize`, and any `cudaMemcpy*` whose copy on the device
(matched by the trace's correlation id) runs device to host. It counts in a
span when it starts inside one of the span's intervals, on any thread (the
autograd engine's calls fall inside the main thread's backward span).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from benchmark.trace_summary import (API_CATS, DEVICE_CATS, _cat, _complete, _intersect,
                                     _intervals, _length, _merge)


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def blocking(events) -> list:
    """Sorted start times of the blocking CUDA API calls among the events."""
    dtoh = {_correlation(e) for e in events
            if _cat(e) == "gpu_memcpy" and "DtoH" in e.get("name", "")}
    dtoh.discard(None)
    out = []
    for e in events:
        if _cat(e) not in API_CATS:
            continue
        n = e.get("name", "")
        if n.endswith("Synchronize") or (n.startswith("cudaMemcpy") and _correlation(e) in dtoh):
            out.append(float(e["ts"]))
    return sorted(out)


def idle_intervals(events):
    """The merged intervals of the traced window in which no device event
    runs; None where the trace holds no device event (a run on the CPU)."""
    busy = _intervals(e for e in events if _cat(e) in DEVICE_CATS)
    if not busy:
        return None
    window = _intervals(events)
    out, cursor = [], window[0][0]
    for a, b in busy:
        if a > cursor:
            out.append([cursor, a])
        cursor = max(cursor, b)
    if window[-1][1] > cursor:
        out.append([cursor, window[-1][1]])
    return out


def index(traced: dict) -> dict:
    """{"idle", "spans": {name: merged intervals}, "blocking"} of the traced
    run's trace, worked out once and kept in `traced`."""
    if "span_index" not in traced:
        events = _complete(traced["trace"])
        spans = defaultdict(list)
        for e in events:
            if _cat(e) == "user_annotation":
                ts = float(e["ts"])
                spans[e.get("name", "?")].append((ts, ts + float(e["dur"])))
        traced["span_index"] = {"idle": idle_intervals(events),
                                "spans": {n: _merge(iv) for n, iv in spans.items()},
                                "blocking": blocking(events)}
    return traced["span_index"]


def idle_ms(ix: dict, name: str):
    """Device-idle ms inside the spans `name`; None where there is none, or
    no device event."""
    iv = ix["spans"].get(name)
    if not iv or ix["idle"] is None:
        return None
    return _length(_intersect(ix["idle"], iv)) / 1e3


def blocking_calls(ix: dict, name: str):
    """Blocking calls that start inside the spans `name`; None where there is
    none, or no device event."""
    iv = ix["spans"].get(name)
    if not iv or ix["idle"] is None:
        return None
    ts = ix["blocking"]
    return sum(bisect.bisect_left(ts, b) - bisect.bisect_left(ts, a) for a, b in iv)


def per(ctx: dict, count: str, value, name: str):
    """value(index, name) per traced step or view (`count`: "steps" or
    "views"); None where the run was not traced or has no such span."""
    t = ctx.get("traced")
    if not t or not t.get(count):
        return None
    v = value(index(t), name)
    return None if v is None else v / t[count]
