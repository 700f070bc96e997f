"""The DM-NeRF field as an nn.Module (port of dmnerf_tpu/models/fields.py).

Architecture (reference DM_NeRF, the same as apply_field):
- trunk: netdepth Linear+ReLU layers of width W; after layer `skip` the encoded
  position is concatenated back in, so layer skip+1 consumes W + pos_ch.
- density head: Linear(W -> 1) on the trunk feature.
- rgb head: Linear(W -> W) (no activation), concat the encoded view direction,
  Linear(W + view_ch -> W/2) + ReLU, Linear(W/2 -> 3).
- instance head: reads the trunk through .detach(), Linear(W -> W),
  Linear(W -> W/2) + ReLU, Linear(W/2 -> ins_num + 1) (last channel = air).
- output columns: [rgb logits 0:3 | sigma 3 | instance logits 4:4+K+1].

Submodule names are the reference state_dict names (mlps.{i}, density_linear,
rgb_feature_linear, rgb_feature_linears.0, rgb_linear, ins_feature_linear,
ins_feature_linears.0, ins_linear), so a reference `.tar` loads with
load_state_dict.

Precision: weights are fp32 masters. With compute_dtype=bfloat16 every matmul
rounds both operands to bf16 and accumulates in fp32 (the products of two bf16
values are exact in fp32), the bias is added in fp32, and the result is stored
in bf16 exactly where the JAX package's `_dot(..., out_dtype=dt)` stores it:
trunk activations, rgb/ins features and the hidden layers. The three heads
return fp32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List

import torch
from torch import nn

from dmnerf_torch.core.encoding import encoding_dim, positional_encoding


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    netdepth: int = 8
    netwidth: int = 256
    multires: int = 10        # PE octaves for positions (-> 63 ch)
    multires_views: int = 4   # PE octaves for view dirs (-> 27 ch)
    skip: int = 4             # skip-concat after this trunk layer index
    ins_num: int = 32         # number of object slots (output has ins_num+1)
    compute_dtype: Any = torch.bfloat16

    @property
    def pos_ch(self) -> int:
        return encoding_dim(self.multires)

    @property
    def view_ch(self) -> int:
        return encoding_dim(self.multires_views)

    @staticmethod
    def from_args(args) -> "FieldConfig":
        dt = (torch.bfloat16 if getattr(args, "precision", "bf16") == "bf16"
              else torch.float32)
        return FieldConfig(
            netdepth=args.netdepth, netwidth=args.netwidth,
            multires=args.multires, multires_views=args.multires_views,
            ins_num=args.ins_num, compute_dtype=dt,
        )


def _dot(x: torch.Tensor, layer: nn.Linear, dtype, out_dtype=None,
         operand=None) -> torch.Tensor:
    """Linear layer: operands rounded to `dtype`, accumulated in fp32 (or
    wider), bias added after the product, result stored in `out_dtype`.
    operand, if given, maps the rounded and widened input before the product
    (parallel/model_parallel.py puts its copy-in there, so that the partial
    input gradients are summed before they are rounded to `dtype`)."""
    acc = torch.promote_types(torch.float32, dtype)
    x = x.to(dtype).to(acc)
    if operand is not None:
        x = operand(x)
    y = (x @ layer.weight.to(dtype).to(acc).T
         + layer.bias.to(acc))
    return y.to(out_dtype) if out_dtype is not None else y


class DMNeRFField(nn.Module):
    def __init__(self, cfg: FieldConfig):
        super().__init__()
        D, W = cfg.netdepth, cfg.netwidth
        # skip == D-1 would concat pos features AFTER the last trunk layer
        # (the reference DM_NeRF breaks identically); skip >= D never fires
        if cfg.skip == D - 1:
            raise ValueError(
                f"skip ({cfg.skip}) == netdepth-1: the skip concat would land "
                f"after the final trunk layer; use skip < netdepth-1 (or >= "
                f"netdepth to disable)")
        self.cfg = cfg
        layers = []
        in_dim = cfg.pos_ch
        for i in range(D):
            layers.append(nn.Linear(in_dim, W))
            in_dim = W + cfg.pos_ch if i == cfg.skip else W
        self.mlps = nn.ModuleList(layers)
        self.density_linear = nn.Linear(W, 1)
        self.rgb_feature_linear = nn.Linear(W, W)
        self.rgb_feature_linears = nn.ModuleList([nn.Linear(W + cfg.view_ch, W // 2)])
        self.rgb_linear = nn.Linear(W // 2, 3)
        self.ins_feature_linear = nn.Linear(W, W)
        self.ins_feature_linears = nn.ModuleList([nn.Linear(W, W // 2)])
        self.ins_linear = nn.Linear(W // 2, cfg.ins_num + 1)

    def _trunk(self, pts: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        h = positional_encoding(pts, cfg.multires).to(dt)
        x_dt = h
        for i, layer in enumerate(self.mlps):
            h = torch.relu(_dot(h, layer, dt, out_dtype=dt))
            if i == cfg.skip:
                h = torch.cat([h, x_dt], dim=-1)
        return h

    def density(self, pts: torch.Tensor) -> torch.Tensor:
        """Trunk + density head only: pts [..., 3] -> raw sigma [..., 1]."""
        dt = self.cfg.compute_dtype
        return _dot(self._trunk(pts), self.density_linear, dt).to(
            torch.promote_types(torch.float32, dt))

    def instance(self, pts: torch.Tensor):
        """Trunk, density and instance heads only (no view directions, no rgb
        branch): pts [..., 3] -> (raw sigma [..., 1], instance logits
        [..., ins_num + 1]), equal to forward's columns 3: for any viewdirs."""
        dt = self.cfg.compute_dtype
        acc = torch.promote_types(torch.float32, dt)
        h = self._trunk(pts)
        ins_f = _dot(h, self.ins_feature_linear, dt, out_dtype=dt)
        ins_f = torch.relu(_dot(ins_f, self.ins_feature_linears[0], dt, out_dtype=dt))
        return (_dot(h, self.density_linear, dt).to(acc),
                _dot(ins_f, self.ins_linear, dt).to(acc))

    def forward(self, pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
        """pts [..., 3], viewdirs [..., 3] broadcastable to pts ->
        raw [..., 4 + ins_num + 1] fp32 (apply_field)."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        d = positional_encoding(viewdirs.expand(pts.shape), cfg.multires_views)
        h = self._trunk(pts)

        density = _dot(h, self.density_linear, dt)

        rgb_f = _dot(h, self.rgb_feature_linear, dt, out_dtype=dt)
        rgb_f = torch.cat([rgb_f, d.to(dt)], dim=-1)
        rgb_f = torch.relu(_dot(rgb_f, self.rgb_feature_linears[0], dt, out_dtype=dt))
        rgb = _dot(rgb_f, self.rgb_linear, dt)

        # the instance branch reads the trunk detached (reference dm_nerf.py:95)
        ins_f = _dot(h.detach(), self.ins_feature_linear, dt, out_dtype=dt)
        ins_f = torch.relu(_dot(ins_f, self.ins_feature_linears[0], dt, out_dtype=dt))
        ins = _dot(ins_f, self.ins_linear, dt)

        return torch.cat([rgb, density, ins], dim=-1).to(
            torch.promote_types(torch.float32, dt))


def init_field_params(generator: torch.Generator, cfg: FieldConfig,
                      scheme: str = "he", device="cpu") -> DMNeRFField:
    """A freshly initialised field on `device`.

    scheme="he" (default): He-uniform weights U(+-sqrt(6/fan_in)) and the
    torch-default bias U(+-1/sqrt(fan_in)); the reference's torch-default
    init collapses the 8-deep ReLU trunk (see dmnerf_tpu/models/fields.py).
    scheme="torch": the exact nn.Linear default, U(+-1/sqrt(fan_in)) for both.
    `generator` is a CPU torch.Generator; the draws are made on the CPU in
    module order (weight, then bias, per layer) and then moved to `device`.
    """
    if scheme not in ("he", "torch"):
        raise ValueError(f"unknown init scheme {scheme!r} (expected 'he' or 'torch')")
    field = DMNeRFField(cfg)
    with torch.no_grad():
        for m in field.modules():
            if isinstance(m, nn.Linear):
                fan_in = m.in_features
                wb = (6.0 / fan_in) ** 0.5 if scheme == "he" else fan_in ** -0.5
                bb = fan_in ** -0.5
                m.weight.uniform_(-wb, wb, generator=generator)
                m.bias.uniform_(-bb, bb, generator=generator)
    return field.to(device)


@functools.lru_cache(maxsize=None)
def param_names(cfg: FieldConfig) -> tuple:
    """DMNeRFField(cfg)'s parameter names in named_parameters order."""
    with torch.device("meta"):
        return tuple(name for name, _ in DMNeRFField(cfg).named_parameters())


def field_tensors(field: DMNeRFField) -> List[torch.Tensor]:
    """A field's weights and biases in param_names order: its parameters, or
    the tensors of a field built by field_of."""
    return [getattr(field.get_submodule(mod), attr)
            for mod, attr in (n.rsplit(".", 1) for n in param_names(field.cfg))]


def field_of(cfg: FieldConfig, tensors: Dict[str, torch.Tensor]) -> DMNeRFField:
    """A DMNeRFField that computes with `tensors` (one per param_names entry)
    as they are, autograd history included: they replace its parameters
    (as plain attributes, unless a tensor is itself a Parameter)."""
    with torch.device("meta"):
        field = DMNeRFField(cfg)
    for name in param_names(cfg):
        mod, attr = name.rsplit(".", 1)
        layer = field.get_submodule(mod)
        del layer._parameters[attr]
        setattr(layer, attr, tensors[name])
    return field
