"""k5_roofline.edit: K5 (the bf16 accumulated-label pass, the fine field's
trunk, density and instance branch fused with its composite;
csrc/render_field.cu's composite_kernel<H_INS>) in the traced edited views,
as a share of its least time: those multiply-adds at each launch's N_test x
(N_samples + N_importance) points against 989 TFLOP/s, or the bytes its
inputs and outputs need once (points, depths, directions, the bf16 trunk
and instance weights; the instance map) against 3.35 TB/s, whichever is
larger (the operations)."""

import re

from benchmark import counts

PATTERN = re.compile(r"\bcomposite_kernel<(?!float\b)[^>]*\b(1|H_INS)>")


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("views"):
        return None
    seconds, launches = counts.matched(t["summary"], PATTERN)
    if not launches:
        return None
    cfg = ctx["cfg"]
    d = counts.field_dims(cfg)
    macs = counts.trunk_macs(cfg) + d["W"] * d["W"] + d["W"] * d["HW"] + d["HW"] * d["K1"]
    R = int(cfg["N_test"]) * launches
    P = R * (int(cfg["N_samples"]) + int(cfg["N_importance"]))
    nbytes = P * 4 * 4 + R * 2 * 3 * 4 + launches * 2 * macs + R * d["K1"] * 4
    return counts.roofline_share(seconds, 2.0 * macs * P, nbytes)
