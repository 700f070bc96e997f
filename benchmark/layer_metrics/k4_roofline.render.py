"""k4_roofline.render: K4 (the bf16 coarse density pass fused with its
weights, csrc/render_field.cu's composite_kernel<H_SIGMA>) in the traced
views, as a share of its least time: the trunk's and density head's
multiply-adds at each launch's N_test x N_samples points against 989
TFLOP/s, or the bytes its inputs and outputs need once (points, depths,
directions, the bf16 trunk weights; the weights [R, S]) against 3.35 TB/s,
whichever is larger (the operations)."""

import re

from benchmark import counts

PATTERN = re.compile(r"\bcomposite_kernel<[^>]*\b(2|H_SIGMA)>")


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("views"):
        return None
    seconds, launches = counts.matched(t["summary"], PATTERN)
    if not launches:
        return None
    cfg = ctx["cfg"]
    R = int(cfg["N_test"]) * launches
    P = R * int(cfg["N_samples"])
    flops = 2.0 * counts.trunk_macs(cfg) * P
    nbytes = (P * 4 * 4 + R * 3 * 4 + launches * 2 * counts.trunk_macs(cfg) + P * 4)
    return counts.roofline_share(seconds, flops, nbytes)
