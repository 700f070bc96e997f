"""k2_roofline.train: K2 (the bf16 field backward, csrc/field.cu's
field_bwd_tile_kernel, dw_partial_kernel and reduce_splits_kernel) in the
traced training steps, as a share of its least time: the activation
gradients and one product per weight at every point of the step
(counts.backward_macs; no forward recompute) against 989 TFLOP/s, or the
bytes its inputs and outputs need once (points, directions, the output
cotangent in fp32, the bf16 weights in and fp32 weight gradients out per
launch) against 3.35 TB/s, whichever is larger (the operations)."""

import re

from benchmark import counts

PATTERN = re.compile(r"\b(field_bwd_tile_kernel|dw_partial_kernel)<(?!float\b)"
                     r"|\breduce_splits_kernel\b")


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
    calls = 2 * t["steps"]
    flops = 2.0 * counts.backward_macs(cfg) * P
    nbytes = (P * 3 * 4 + rays * 3 * 4 + P * (5 + int(cfg["ins_num"])) * 4
              + calls * 3 * counts.weight_bytes_bf16(cfg))
    return counts.roofline_share(seconds, flops, nbytes)
