"""edit_mfu: the field FLOPs of the untraced half's edited views over its
wall time, as a share of the bf16 peak. A view with one moved object puts
each of its rays through K1 at 2 x N_samples coarse points and 2 x
(N_samples + 2 x N_importance) fine points (768 at 64 + 128: the original
and the target rays) and through K5 at 2 x (N_samples + N_importance)
points (384); K1 counts the whole field, K5 the trunk, the density and the
instance branch."""

from benchmark import counts


def ins_macs(cfg) -> int:
    """Per point: the instance branch, W -> W -> W/2 -> ins_num + 1."""
    d = counts.field_dims(cfg)
    return d["W"] * d["W"] + d["W"] * d["HW"] + d["HW"] * d["K1"]


def flops_per_view(cfg) -> float:
    n_s, n_i = int(cfg["N_samples"]), int(cfg["N_importance"])
    k1 = 2 * n_s + 2 * (n_s + 2 * n_i)
    k5 = 2 * (n_s + n_i)
    return 2.0 * (k1 * counts.forward_macs(cfg) + k5 * (counts.trunk_macs(cfg) + ins_macs(cfg))) \
        * counts.rays_per_view(cfg)


def read(ctx):
    u = ctx.get("untraced")
    if not u or not u.get("views"):
        return None
    return 100.0 * flops_per_view(ctx["cfg"]) * u["views"] / u["seconds"] / counts.PEAK_BF16_FLOPS
