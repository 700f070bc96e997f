"""train_mfu: model FLOPs of the untraced half's steps (6 x the forward
multiply-adds x the step's points, counts.train_model_flops_per_step) over
its wall time, as a share of the bf16 peak."""

from benchmark import counts


def read(ctx):
    u = ctx.get("untraced")
    if not u or not u.get("steps"):
        return None
    flops = counts.train_model_flops_per_step(ctx["cfg"]) * u["steps"]
    return 100.0 * flops / u["seconds"] / counts.PEAK_BF16_FLOPS
