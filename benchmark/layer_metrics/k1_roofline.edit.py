"""k1_roofline.edit: K1 (the bf16 field forward, csrc/field.cu's
field_forward_kernel) in the traced edited views, as a share of its least
time: the whole field's multiply-adds at every point against 989 TFLOP/s,
or the bytes its inputs and outputs need once (points, directions, the bf16
weights of each launch, raw out in fp32) against 3.35 TB/s, whichever is
larger (the operations). A chunk of N_test rays with one moved object makes
four launches, two coarse at N_test x N_samples points and two fine at
N_test x (N_samples + 2 x N_importance): N_test x (N_samples +
N_importance) points a launch on average."""

import re

from benchmark import counts

PATTERN = re.compile(r"\bfield_forward_kernel<(?!float\b)")


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("views"):
        return None
    seconds, launches = counts.matched(t["summary"], PATTERN)
    if not launches:
        return None
    cfg = ctx["cfg"]
    rays = int(cfg["N_test"]) * launches
    P = rays * (int(cfg["N_samples"]) + int(cfg["N_importance"]))
    flops = 2.0 * counts.forward_macs(cfg) * P
    nbytes = (P * 3 * 4 + rays * 3 * 4 + launches * counts.weight_bytes_bf16(cfg)
              + P * (5 + int(cfg["ins_num"])) * 4)
    return counts.roofline_share(seconds, flops, nbytes)
