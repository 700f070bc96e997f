"""device_idle.edit: percent of the traced half of an edit window in which
no kernel, copy or memset ran on the card."""


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("views") or not t["summary"]["busy_ms"]:
        return None
    return 100.0 * (1.0 - t["summary"]["busy_share"])
