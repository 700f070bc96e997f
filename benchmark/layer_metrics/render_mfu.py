"""render_mfu: the field FLOPs of the untraced half's views
(counts.render_flops_per_view) over its wall time, as a share of the bf16
peak."""

from benchmark import counts


def read(ctx):
    u = ctx.get("untraced")
    if not u or not u.get("views"):
        return None
    flops = counts.render_flops_per_view(ctx["cfg"]) * u["views"]
    return 100.0 * flops / u["seconds"] / counts.PEAK_BF16_FLOPS
