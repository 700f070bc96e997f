"""k3_roofline.render: K3 (the bf16 fine pass fused with its composite,
csrc/render_field.cu's composite_kernel<H_ALL>) in the traced views, as a
share of its least time: the whole field's multiply-adds at each launch's
N_test x (N_samples + N_importance) points against 989 TFLOP/s, or the bytes
its inputs and outputs need once (points, depths, directions, the bf16
weights; rgb, depth and the instance logits) against 3.35 TB/s, whichever
is larger (the operations)."""

import re

from benchmark import counts

PATTERN = re.compile(r"\bcomposite_kernel<[^>]*\b(0|H_ALL)>")


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("views"):
        return None
    seconds, launches = counts.matched(t["summary"], PATTERN)
    if not launches:
        return None
    cfg = ctx["cfg"]
    R = int(cfg["N_test"]) * launches
    P = R * (int(cfg["N_samples"]) + int(cfg["N_importance"]))
    flops = 2.0 * counts.forward_macs(cfg) * P
    nbytes = (P * 4 * 4 + R * 2 * 3 * 4 + launches * counts.weight_bytes_bf16(cfg)
              + R * (3 + 1 + int(cfg["ins_num"]) + 1) * 4)
    return counts.roofline_share(seconds, flops, nbytes)
