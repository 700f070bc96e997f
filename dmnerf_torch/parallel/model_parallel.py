# Ported from dmnerf_tpu/parallel/mesh.py (shard_params_model; the tensor-parallel field over the 'model' axis of the 2-D mesh).
"""Tensor parallelism over the fields' output features: the 'model' axis of
the 2-D (data, model) mesh (parallel/mesh.py::make_mesh_2d).

The JAX package constrains every parameter leaf with shard_params_model and
lets the XLA partitioner insert the collectives. PyTorch inserts none, so
here the rule picks each rank's rows once (shard_params_model) and the
field's forward makes the collectives explicit:

- model_spec is the JAX rule on a reference [in, out] shape: a 2-D kernel
  splits its output features, a 1-D bias splits outright, when the size
  divides by `model`; anything else (the density head [W, 1], the rgb head
  [W/2, 3], an instance head of odd width) is replicated. A torch nn.Linear
  keeps [out, in], so its split rows are dim 0 of the weight and the bias.
- ModelShardedField is the column-parallel DMNeRFField: each split layer
  takes the whole input through copy_in (identity forward; its backward sums
  the partial input gradients over the model group in fp32, before the
  rounding to the compute dtype, since each rank's columns give only part
  of dX), multiplies by its own rows, and gather_out
  joins the columns (its backward hands each rank its own columns of the
  cotangent and sums nothing: the work after the gather repeats on every
  model rank, so each rank's cotangent already is the whole one). The
  replicated heads run whole on every model rank.
- ModelShardedField.gathered() is the whole field, its weights gathered
  through gather_out, for the kernels K1/K2: every model rank runs the
  kernels on its data rows with all the weights (the JAX package's
  shard_map over 'data' with P() weights), K2's dW is the same whole tensor
  on every model rank, and gather_out's backward keeps this rank's rows.

Gradients therefore need only the data group's sum (parallel/mesh.py::
all_reduce_grads over mesh.data_axis), for split and replicated leaves
alike. Every gather is an all-reduce of a zero-filled fp32 buffer (gloo has
no CUDA all_gather; bf16 -> fp32 -> bf16 and x + 0 are exact), so gathering
changes no bit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist
from torch import nn

from dmnerf_torch.core.encoding import positional_encoding
from dmnerf_torch.models.fields import DMNeRFField, FieldConfig, _dot, field_of, param_names
from dmnerf_torch.parallel.mesh import DataMesh, Mesh2D


def model_spec(shape: Sequence[int], m: int) -> tuple:
    """The JAX shard_params_model rule for a leaf of reference shape
    ([in, out] kernel or [out] bias) on a model axis of size m, as the tuple
    of its PartitionSpec: (None, "model"), ("model",) or ()."""
    if len(shape) == 2 and shape[1] % m == 0:
        return (None, "model")
    if len(shape) == 1 and shape[0] % m == 0:
        return ("model",)
    return ()


def is_split(torch_shape: Sequence[int], m: int) -> bool:
    """Whether a torch weight [out, in] or bias [out] splits its dim 0 over m."""
    return "model" in model_spec(tuple(reversed(tuple(torch_shape))), m)


def _sum_fp32(t: torch.Tensor, axis: DataMesh) -> torch.Tensor:
    """The sum of t over the axis's group, added in fp32 (bf16 widens exactly)."""
    y = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=axis.group)
    return y.to(t.dtype)


class _CopyIn(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # one rank: g as it is, strides included (a copy could reorder the
        # sums of the products that read it)
        return (g if ctx.axis.size == 1 else _sum_fp32(g, ctx.axis)), None


class _GatherOut(torch.autograd.Function):
    """Each model rank's block of `dim` joined in rank order; the backward
    takes this rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, t.shape[dim]
        shape = list(t.shape)
        shape[dim] *= axis.size
        whole = t.new_zeros(shape, dtype=torch.float32)
        whole.narrow(dim, axis.rank * ctx.n, ctx.n).copy_(t)
        dist.all_reduce(whole, group=axis.group)
        return whole.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


def copy_in(x: torch.Tensor, mesh: Mesh2D) -> torch.Tensor:
    return _CopyIn.apply(x, mesh.model_axis)


def gather_out(t: torch.Tensor, mesh: Mesh2D, dim: int = -1) -> torch.Tensor:
    return _GatherOut.apply(t, mesh.model_axis, dim % t.dim())


class ModelShardedField(nn.Module):
    """DMNeRFField with every layer whose output features divide by the
    model axis split column-parallel over it: this rank holds its rows of
    those layers and the whole of the rest. The submodule names and the
    parameter order are DMNeRFField's; forward(pts, viewdirs) gives its raw
    [..., 4 + ins_num + 1] (up to the order of fp32 sums)."""

    def __init__(self, cfg: FieldConfig, mesh: Mesh2D):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        with torch.device("meta"):
            full = DMNeRFField(cfg)
        for name, child in full.named_children():
            setattr(self, name, self._local(child))

    def _local(self, module):
        if isinstance(module, nn.ModuleList):
            return nn.ModuleList(self._local(m) for m in module)
        split = is_split(module.weight.shape, self.mesh.model)
        layer = nn.Linear(module.in_features, module.out_features // self.mesh.model
                          if split else module.out_features, device="meta")
        layer.model_split = split
        return layer

    def _layer(self, x, layer, out_dtype=None, relu=False):
        dt = self.cfg.compute_dtype
        # the copy-in sits on the widened input, so the partial input
        # gradients are summed in fp32 and rounded to dt once, as one rank's
        y = _dot(x, layer, dt, out_dtype,
                 operand=(lambda xa: copy_in(xa, self.mesh)) if layer.model_split else None)
        if relu:
            y = torch.relu(y)
        return gather_out(y, self.mesh) if layer.model_split else y

    def forward(self, pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        d = positional_encoding(viewdirs.expand(pts.shape), cfg.multires_views)
        h = x_dt = positional_encoding(pts, cfg.multires).to(dt)
        for i, layer in enumerate(self.mlps):
            h = self._layer(h, layer, dt, relu=True)
            if i == cfg.skip:
                h = torch.cat([h, x_dt], dim=-1)

        density = self._layer(h, self.density_linear)
        rgb_f = self._layer(h, self.rgb_feature_linear, dt)
        rgb_f = torch.cat([rgb_f, d.to(dt)], dim=-1)
        rgb_f = self._layer(rgb_f, self.rgb_feature_linears[0], dt, relu=True)
        rgb = self._layer(rgb_f, self.rgb_linear)

        # the instance branch reads the trunk detached (reference dm_nerf.py:95)
        ins_f = self._layer(h.detach(), self.ins_feature_linear, dt)
        ins_f = self._layer(ins_f, self.ins_feature_linears[0], dt, relu=True)
        ins = self._layer(ins_f, self.ins_linear)
        return torch.cat([rgb, density, ins], dim=-1).to(
            torch.promote_types(torch.float32, dt))

    def splits(self) -> List[bool]:
        """Whether each parameter (in param_names order) is split."""
        return [self.get_submodule(n.rsplit(".", 1)[0]).model_split
                for n in param_names(self.cfg)]

    def gathered(self) -> DMNeRFField:
        """The whole field, computing with this field's parameters gathered
        over the model group (differentiable: see gather_out)."""
        tensors = {n: gather_out(p, self.mesh, 0) if s else p
                   for (n, p), s in zip(self.named_parameters(), self.splits())}
        return field_of(self.cfg, tensors)


def take_rows(t: torch.Tensor, split: bool, mesh: Mesh2D) -> torch.Tensor:
    """This model rank's rows of a whole leaf (the leaf itself if replicated)."""
    return t.chunk(mesh.model, 0)[mesh.rank % mesh.model] if split else t


@torch.no_grad()
def gather_rows(t: torch.Tensor, split: bool, mesh: Mesh2D) -> torch.Tensor:
    """The whole leaf from every model rank's rows (the inverse of take_rows)."""
    return gather_out(t, mesh, 0) if split else t


def shard_params_model(params: Dict[str, DMNeRFField], mesh: Mesh2D
                       ) -> Dict[str, ModelShardedField]:
    """{"coarse", "fine"} whole fields -> ModelShardedFields holding this
    rank's rows of every split leaf and the whole of every replicated one,
    on the fields' device."""
    out = {}
    for key, field in params.items():
        shard = ModelShardedField(field.cfg, mesh).to_empty(
            device=field.mlps[0].weight.device)
        with torch.no_grad():
            for (_, p), full, s in zip(shard.named_parameters(), field.parameters(),
                                       shard.splits()):
                p.copy_(take_rows(full.detach(), s, mesh))
        out[key] = shard
    return out


def gather_params_model(params: Dict[str, nn.Module]) -> Dict[str, nn.Module]:
    """The inverse of shard_params_model: every ModelShardedField becomes a
    whole DMNeRFField (new parameters, no autograd history); other values
    pass as they are. Collective over each field's model group."""
    return {key: _whole(field) if isinstance(field, ModelShardedField) else field
            for key, field in params.items()}


def _whole(field: ModelShardedField) -> DMNeRFField:
    with torch.device("meta"):
        whole = DMNeRFField(field.cfg)
    whole = whole.to_empty(device=field.mlps[0].weight.device)
    with torch.no_grad():
        for p, t, s in zip(whole.parameters(), field.parameters(), field.splits()):
            p.copy_(gather_rows(t.detach(), s, field.mesh))
    return whole


def model_sharded(params) -> bool:
    """Whether a {"coarse", "fine"} dict holds ModelShardedFields."""
    return any(isinstance(f, ModelShardedField) for f in params.values())
