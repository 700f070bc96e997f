"""host_wait_ms.train: milliseconds per traced step that the host spent in
CUDA API calls that copy or synchronize (cudaMemcpy*, *Synchronize)."""


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("steps"):
        return None
    ms, calls = t["summary"]["host"]["copy or wait"]
    return ms / t["steps"] if calls else None
