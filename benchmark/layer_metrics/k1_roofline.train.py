"""k1_roofline.train: K1 (the bf16 field forward, csrc/field.cu's
field_forward_kernel) in the traced training steps, as a share of its least
time: the whole field's multiply-adds at every point of the step (coarse and
fine) against 989 TFLOP/s, or the bytes its inputs and outputs need once
(points, directions, the bf16 weights of each launch, raw out in fp32)
against 3.35 TB/s, whichever is larger (the operations, at these shapes)."""

import re

from benchmark import counts

PATTERN = re.compile(r"\bfield_forward_kernel<(?!float\b)")


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("steps"):
        return None
    seconds, launches = counts.matched(t["summary"], PATTERN)
    if not launches:
        return None
    cfg = ctx["cfg"]
    P = counts.points_per_step(cfg) * t["steps"]
    rays = 2 * int(cfg["N_train"]) * t["steps"]
    flops = 2.0 * counts.forward_macs(cfg) * P
    nbytes = (P * 3 * 4 + rays * 3 * 4 + launches * counts.weight_bytes_bf16(cfg)
              + P * (5 + int(cfg["ins_num"])) * 4)
    return counts.roofline_share(seconds, flops, nbytes)
