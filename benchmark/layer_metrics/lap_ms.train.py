"""lap_ms.train: milliseconds per traced step in the instance loss's host
spans, the copy of the costs to the host and the Hungarian solve
(record_function "lap.copy_to_host" and "lap.solve" in
dmnerf_torch/losses/instance.py)."""


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("steps"):
        return None
    lap = t["summary"]["lap"]
    if not any(n for _, n in lap.values()):
        return None
    return sum(ms for ms, _ in lap.values()) / t["steps"]
