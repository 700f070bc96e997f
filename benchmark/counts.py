"""The work the benchmark's inputs need, from their shapes alone: the
multiply-adds of the DM-NeRF field and the peaks of one NVIDIA H100.

A frozen copy of the port's own arithmetic (`field_macs` of the smoke run),
with one change: the backward pass is counted as the algorithm needs it, the
activation gradients (dX) and one product per weight (dW), and not the forward
recompute that one implementation of it chooses. So a roofline share reads the
same whatever implements the kernel.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def encoding_dim(multires: int, input_dims: int = 3) -> int:
    """Channels of the positional encoding [x, sin(2^i x), cos(2^i x)]."""
    return input_dims * (1 + 2 * multires) if multires > 0 else input_dims


def field_dims(cfg: dict) -> dict:
    D, W = int(cfg["netdepth"]), int(cfg["netwidth"])
    return {"D": D, "W": W, "HW": W // 2, "X": encoding_dim(int(cfg["multires"])),
            "V": encoding_dim(int(cfg["multires_views"])), "skip": int(cfg.get("skip", 4)),
            "K1": int(cfg["ins_num"]) + 1}


def trunk_macs(cfg: dict) -> int:
    """Per point: the trunk (the skip layer reads W + X) and the density head."""
    d = field_dims(cfg)
    D, W, X = d["D"], d["W"], d["X"]
    return X * W + (D - 1) * W * W + (X * W if d["skip"] + 1 < D else 0) + W


def forward_macs(cfg: dict) -> int:
    """Per point: the whole field, trunk, density, rgb and instance heads."""
    d = field_dims(cfg)
    W, HW, V, K1 = d["W"], d["HW"], d["V"], d["K1"]
    ins = W * W + W * HW + HW * K1
    rgb = W * W + (W + V) * HW + HW * 3
    return trunk_macs(cfg) + ins + rgb


def backward_dx_macs(cfg: dict) -> int:
    """Per point: the activation gradients a training step needs. The output
    layers back to their hidden layers, the two hidden layers back to the
    features (the rgb one only into its W trunk columns, not the view
    encoding), the density head and the rgb feature layer back into the trunk
    (the instance branch reads the trunk detached, so nothing of it flows
    there), and the trunk's layers after the first (the points need no
    gradient, so neither does the encoding)."""
    d = field_dims(cfg)
    D, W, HW, K1 = d["D"], d["W"], d["HW"], d["K1"]
    return (HW * K1 + HW * 3) + W * HW + W * HW + W + W * W + (D - 1) * W * W


def backward_macs(cfg: dict) -> int:
    """Per point: dX and dW, one product per weight for dW (forward_macs)."""
    return backward_dx_macs(cfg) + forward_macs(cfg)


def points_per_step(cfg: dict) -> int:
    """Field points of one training step: the coarse pass and the fine pass
    over the union of the coarse and the importance samples."""
    n_s, n_i = int(cfg["N_samples"]), int(cfg["N_importance"])
    return int(cfg["N_train"]) * (n_s + n_s + n_i)


def train_model_flops_per_step(cfg: dict) -> float:
    """6 x the forward multiply-adds x the points of a step (model FLOPs)."""
    return 6.0 * forward_macs(cfg) * points_per_step(cfg)


def rays_per_view(cfg: dict) -> int:
    return int(cfg["H"]) * int(cfg["W"])


def render_flops_per_view(cfg: dict) -> float:
    """2 x (coarse samples x trunk and density + fine samples x the whole
    field) x the rays of a view."""
    n_s, n_i = int(cfg["N_samples"]), int(cfg["N_importance"])
    return 2.0 * (n_s * trunk_macs(cfg) + (n_s + n_i) * forward_macs(cfg)) * rays_per_view(cfg)


def weight_bytes_bf16(cfg: dict) -> int:
    """The packed weights as the kernels read them: bf16 matrices, fp32 biases."""
    d = field_dims(cfg)
    D, W, HW, K1 = d["D"], d["W"], d["HW"], d["K1"]
    biases = D * W + 1 + W + HW + 3 + W + HW + K1
    return 2 * forward_macs(cfg) + 4 * biases   # one weight per multiply-add


def least_time_s(flops: float, nbytes: float) -> tuple:
    """(seconds, 'operations' or 'bytes'): the larger of the operations over
    the bf16 peak and the bytes over the memory peak."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def matched(summary: dict, pattern) -> tuple:
    """(device seconds, launches) of the trace's kernels whose names match."""
    hits = [v for name, v in summary["by_name"].items() if pattern.search(name)]
    return sum(ms for ms, _ in hits) / 1e3, sum(n for _, n in hits)


def roofline_share(seconds: float, flops: float, nbytes: float):
    """Percent of the least time (least_time_s) that `seconds` is, or None
    where nothing ran."""
    if seconds <= 0:
        return None
    return 100.0 * least_time_s(flops, nbytes)[0] / seconds
