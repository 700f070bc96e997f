"""The DM-NeRF field in plain float32 PyTorch (arXiv:2208.07227; the layer
names are those of the authors' `DM_NeRF` module).

- trunk: netdepth Linear+ReLU layers of width W on the positional encoding
  [x, sin(2^i x), cos(2^i x)]; after layer `skip` the encoding is
  concatenated back in.
- density: Linear(W -> 1) on the trunk.
- rgb: Linear(W -> W), concatenated with the view encoding, Linear(-> W/2) +
  ReLU, Linear(W/2 -> 3).
- instance: on the trunk with its gradient stopped, Linear(W -> W),
  Linear(W -> W/2) + ReLU, Linear(W/2 -> ins_num + 1), the last channel "air".
- output columns: [rgb logits | sigma | instance logits].

`quantize` rounds both operands of every product before it is taken, and
the product is summed in float32: None is float32 throughout; "bf16" rounds
each operand to bfloat16, the precision the configurations state (a bf16
matrix product with float32 accumulation; the biases stay float32); "fp8"
rounds each operand to float8 e4m3 with one scale per tensor (its largest
magnitude maps to 448), the precision below bfloat16 that serves as the
comparison's control. Gradients pass every rounding straight.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def strict_fp32() -> None:
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def leaf_specs(cfg: dict):
    """[(name, shape, fan_in)] of one field's weights and biases, in the
    order of the authors' module."""
    D, W = int(cfg["netdepth"]), int(cfg["netwidth"])
    X = 3 * (1 + 2 * int(cfg["multires"]))
    V = 3 * (1 + 2 * int(cfg["multires_views"]))
    skip, K1 = int(cfg.get("skip", 4)), int(cfg["ins_num"]) + 1
    layers, k_in = [], X
    for i in range(D):
        layers.append((f"mlps.{i}", W, k_in))
        k_in = W + X if i == skip else W
    layers += [("density_linear", 1, W), ("rgb_feature_linear", W, W),
               ("rgb_feature_linears.0", W // 2, W + V), ("rgb_linear", 3, W // 2),
               ("ins_feature_linear", W, W), ("ins_feature_linears.0", W // 2, W),
               ("ins_linear", K1, W // 2)]
    out = []
    for name, n_out, n_in in layers:
        out.append((f"{name}.weight", (n_out, n_in), n_in))
        out.append((f"{name}.bias", (n_out,), n_in))
    return out


def octave_scale(multires: int, device) -> torch.Tensor:
    """[1, 1, 1, then 2^-i for the six channels of octave i] over an encoding."""
    s = [1.0] * 3 + [2.0 ** -i for i in range(multires) for _ in range(6)]
    return torch.tensor(s, dtype=torch.float32, device=device)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """One field's weights from `seed`, made on `device` by one uniform draw:
    He-uniform weights U(+-sqrt(6/fan_in)) and biases U(+-1/sqrt(fan_in)),
    float32; the weights that read the position and view encodings (the
    first trunk layer, the skip layer's encoding columns, the rgb hidden
    layer's view columns) scaled by 2^-i on octave i. A trained field gives
    its high octaves little weight; at He-uniform's equal weights the random
    field would change within a thousandth of the scene, and a pixel's colour
    would swing with the rounding of its sample depths."""
    specs = leaf_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = sum(math.prod(shape) for _, shape, _ in specs)
    flat = torch.rand(n, generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape, fan_in in specs:
        size = math.prod(shape)
        bound = math.sqrt(6.0 / fan_in) if name.endswith("weight") else fan_in ** -0.5
        out[name] = (flat[at:at + size] * bound).reshape(shape)
        at += size
    W, skip = int(cfg["netwidth"]), int(cfg.get("skip", 4))
    pos = octave_scale(int(cfg["multires"]), device)
    out["mlps.0.weight"] = out["mlps.0.weight"] * pos
    if skip + 1 < int(cfg["netdepth"]):
        w = out[f"mlps.{skip + 1}.weight"]
        out[f"mlps.{skip + 1}.weight"] = torch.cat([w[:, :W], w[:, W:] * pos], 1)
    w = out["rgb_feature_linears.0.weight"]
    out["rgb_feature_linears.0.weight"] = torch.cat(
        [w[:, :W], w[:, W:] * octave_scale(int(cfg["multires_views"]), device)], 1)
    return out


def posenc(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(m-1) x), cos(2^(m-1) x)]."""
    parts = [x]
    for i in range(multires):
        f = float(2.0 ** i)
        parts += [torch.sin(f * x), torch.cos(f * x)]
    return torch.cat(parts, dim=-1)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor, as float32."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()           # the rounding passes gradients straight


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), as float32."""
    return x + (x.detach().to(torch.bfloat16).to(torch.float32) - x.detach())


ROUND = {"fp8": fp8_round, "bf16": bf16_round}


def linear(w: dict, name: str, x: torch.Tensor, quantize=None) -> torch.Tensor:
    wt = w[f"{name}.weight"]
    if quantize is not None:
        x, wt = ROUND[quantize](x), ROUND[quantize](wt)
    return x @ wt.T + w[f"{name}.bias"]


def trunk(w: dict, cfg: dict, pts: torch.Tensor, quantize=None) -> torch.Tensor:
    x = posenc(pts, int(cfg["multires"]))
    h = x
    for i in range(int(cfg["netdepth"])):
        h = torch.relu(linear(w, f"mlps.{i}", h, quantize))
        if i == int(cfg.get("skip", 4)):
            h = torch.cat([h, x], dim=-1)
    return h


def density(w: dict, cfg: dict, pts: torch.Tensor, quantize=None) -> torch.Tensor:
    """pts [P, 3] -> sigma [P]."""
    return linear(w, "density_linear", trunk(w, cfg, pts, quantize), quantize)[:, 0]


def field(w: dict, cfg: dict, pts: torch.Tensor, viewdirs: torch.Tensor,
          quantize=None) -> torch.Tensor:
    """pts [P, 3], viewdirs [P, 3] -> raw [P, 4 + ins_num + 1]."""
    h = trunk(w, cfg, pts, quantize)
    sigma = linear(w, "density_linear", h, quantize)
    f = linear(w, "rgb_feature_linear", h, quantize)
    f = torch.cat([f, posenc(viewdirs, int(cfg["multires_views"]))], dim=-1)
    f = torch.relu(linear(w, "rgb_feature_linears.0", f, quantize))
    rgb = linear(w, "rgb_linear", f, quantize)
    g = linear(w, "ins_feature_linear", h.detach(), quantize)
    g = torch.relu(linear(w, "ins_feature_linears.0", g, quantize))
    ins = linear(w, "ins_linear", g, quantize)
    return torch.cat([rgb, sigma, ins], dim=-1)
