"""Field forward (K1) and backward (K2) for training: CUDA kernels in
csrc/field.cu.

Port of dmnerf_tpu/ops/pallas/field_kernels.py, the custom VJP
`fused_field_packed`:

- field_forward (K1, `_fwd_call`): raw [..., 4+K+1] fp32 for points and view
  directions, from the packed weights of kernels/render_field.py::pack_field.
- field_backward (K2, `_fused_bwd`): the forward again, backprop through the
  heads and the trunk (the instance branch passes nothing into the trunk),
  dW/db in the packed layouts (fp32, deterministic) and, on request, the
  cotangents of the position and view encodings.
- FusedField: the torch.autograd.Function over the two; its backward returns
  the gradients in the module's own parameter layout (unpack_grads, the
  counterpart of the slice VJP of pack_params) and carries the encoding
  cotangents through the positional encoding to points and directions.

Beside each kernel is its plain PyTorch version: field_forward_ref is
DMNeRFField.forward; field_backward_ref is the explicit math of the TPU
kernel's `_bwd_kernel`, rounding to the compute dtype exactly where it does,
with every product taken in fp32 on operands that are exact in fp32. A wrapper
takes the plain version for CPU tensors only; for a CUDA tensor it launches
the kernel or raises. LAUNCHES counts the launches of each kernel.

Each kernel has a bf16 build and an f32 build (precision f32: fp32 weights,
activations, products and sums); the wrappers pick the build from the packed
weights' dtype, and count its launches under its own key (`_f32`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from dmnerf_torch.core.encoding import encoding_dim, positional_encoding
from dmnerf_torch.kernels.render_field import (PackedField, Params, _as_field, _device_kind,
                                               build_of, check_kernel_shape, pack_field)
from dmnerf_torch.models.fields import FieldConfig, field_tensors, param_names

# launches of each kernel since the last reset (the CPU plain path adds none)
LAUNCHES: Dict[str, int] = {"field_forward": 0, "field_backward": 0,
                            "field_forward_f32": 0, "field_backward_f32": 0}
# launches of K2's bf16 build by the core that ran them (k2_core)
K2_CORES: Dict[str, int] = {"wgmma": 0, "mma_sync": 0}

# points per fixed-order partial of K2's dW and bias sums (a multiple of either
# dW pass's stages: 32 points on the mma.sync core, 64 on field_bwd_wgmma.cuh)
PSPLIT = 16384
# points per chunk of the plain backward (bounds its fp32 activations)
REF_CHUNK = 1 << 16


def reset_launches() -> None:
    for counts in (LAUNCHES, K2_CORES):
        for k in counts:
            counts[k] = 0


class Layout(NamedTuple):
    """The packed layout, read from PackedField.meta (csrc's `Meta` order)."""
    D: int
    W: int
    skip: int
    XP: int
    DP: int
    CP: int
    C: int
    multires: int
    multires_views: int
    off_t: tuple
    off_rgbf: int
    off_rh: int
    off_insf: int
    off_ih: int
    off_out: int
    boff_t: int
    boff_rgbf: int
    boff_rh: int
    boff_insf: int
    boff_ih: int
    boff_o: int

    def k_in(self, i: int) -> int:
        """Packed rows of trunk matrix i."""
        if i == 0:
            return self.XP
        return self.W + self.XP if i == self.skip + 1 else self.W


def layout(packed: PackedField) -> Layout:
    m = [int(v) for v in packed.meta]
    D = m[0]
    return Layout(*m[:9], tuple(m[9:9 + D]), *m[25:36])


# shared memory a block may take on the H100 (opt-in), bytes
SMEM_H100 = 232448


def k2_core(L: Layout, dtype: torch.dtype) -> Optional[str]:
    """The core that K2's bf16 build runs for the packed layout L: "wgmma"
    (csrc/field_bwd_wgmma.cuh: a producer warpgroup, a TMA-fed weight ring,
    wgmma consumer warpgroups) for widths 128 and 256 with 4+K+1 padded at
    most 128, where a tile's activations (64-column blocks), the hidden
    layers' biases and a weight ring of two stages fit the H100's shared
    memory (k2w::fits holds the same rule); else "mma_sync" (field_core.cuh).
    None for the f32 build."""
    if dtype != torch.bfloat16:
        return None
    W = L.W
    if W not in (128, 256) or L.CP > 128:
        return "mma_sync"
    blocks = W // 64 + -(-(W + max(L.CP, L.DP)) // 64)      # of H and Bf, per warpgroup
    biases = -(-L.boff_o * 4 // 1024) * 1024                  # the hidden layers', fp32
    smem = 1024 + 2 * blocks * 64 * 128 + biases + 2 * (W * 64 + 16)
    return "wgmma" if smem <= SMEM_H100 else "mma_sync"


class FieldGrads(NamedTuple):
    dw: torch.Tensor            # [len(packed.w)] fp32, the packed weight layout
    db: torch.Tensor            # [len(packed.b)] fp32, the packed bias layout
    gx: Optional[torch.Tensor]  # [P, XP] fp32 position-encoding cotangent
    gd: Optional[torch.Tensor]  # [P, DP] fp32 view-encoding cotangent


def flatten_inputs(pts: torch.Tensor, viewdirs: torch.Tensor):
    """pts [..., 3] and viewdirs of the same shape, or [..., 1, 3] shared by
    the samples of a ray -> (pts [P, 3], dirs [P / ppd, 3], ppd)."""
    if pts.shape[-1] != 3 or viewdirs.shape[-1] != 3:
        raise ValueError(f"field: points {tuple(pts.shape)} and directions "
                         f"{tuple(viewdirs.shape)} must end in 3")
    P = math.prod(pts.shape[:-1])
    if viewdirs.shape == pts.shape:
        return pts.reshape(P, 3), viewdirs.reshape(P, 3), 1
    if (pts.dim() >= 2 and viewdirs.dim() == pts.dim() and viewdirs.shape[-2] == 1
            and viewdirs.shape[:-2] == pts.shape[:-2]):
        return pts.reshape(P, 3), viewdirs.reshape(-1, 3), pts.shape[-2]
    raise ValueError(f"field: directions {tuple(viewdirs.shape)} do not match "
                     f"points {tuple(pts.shape)} (same shape, or [..., 1, 3])")


# ---- plain PyTorch versions -------------------------------------------------

def field_forward_ref(field, pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """raw [..., C] fp32: DMNeRFField.forward."""
    return field(pts, viewdirs)


def field_backward_ref(packed: PackedField, pts: torch.Tensor, dirs: torch.Tensor,
                       ppd: int, g: torch.Tensor, need_x: bool = False,
                       need_d: bool = False) -> FieldGrads:
    """The TPU kernel's `_bwd_kernel` in PyTorch, on the packed weights.

    pts [P, 3], dirs [P / ppd, 3], g [P, C] fp32 (the cotangent of raw).
    Rounds to the compute dtype (the pack's dtype) where `_bwd_kernel` does:
    g for the products (the output bias sums the unrounded g), every
    activation gradient after its product and ReLU mask, the encodings, and
    every recomputed activation. The cotangents gx/gd are returned unrounded,
    as the kernel returns them; callers round them to the compute dtype."""
    L = layout(packed)
    D, W, HW, XP, DP, CP, C, skip = L.D, L.W, L.W // 2, L.XP, L.DP, L.CP, L.C, L.skip
    dt = packed.w.dtype
    acc = torch.promote_types(torch.float32, dt)
    dev = pts.device
    w, b = packed.w, packed.b.to(acc)

    def mat(off, k, n):
        return w[off:off + k * n].view(k, n).to(acc)

    def rd(t):
        return t.to(dt).to(acc)

    T = [mat(L.off_t[i], L.k_in(i), W) for i in range(D)]
    bt = [b[L.boff_t + i * W:L.boff_t + (i + 1) * W] for i in range(D)]
    Wrgbf, Winsf = mat(L.off_rgbf, W, W), mat(L.off_insf, W, W)
    Wrh, Wih = mat(L.off_rh, W + DP, HW), mat(L.off_ih, W, HW)
    Wout = mat(L.off_out, 2 * W, CP)
    brgbf, binsf = b[L.boff_rgbf:L.boff_rgbf + W], b[L.boff_insf:L.boff_insf + W]
    brh, bih = b[L.boff_rh:L.boff_rh + HW], b[L.boff_ih:L.boff_ih + HW]

    dw = torch.zeros(w.numel(), dtype=acc, device=dev)
    db = torch.zeros(b.numel(), dtype=acc, device=dev)

    def gmat(off, k, n):                 # a view into dw
        return dw[off:off + k * n].view(k, n)

    dT = [gmat(L.off_t[i], L.k_in(i), W) for i in range(D)]
    dWrgbf, dWinsf = gmat(L.off_rgbf, W, W), gmat(L.off_insf, W, W)
    dWrh, dWih = gmat(L.off_rh, W + DP, HW), gmat(L.off_ih, W, HW)
    dWout = gmat(L.off_out, 2 * W, CP)
    P = pts.shape[0]
    gx = torch.zeros((P, XP), dtype=acc, device=dev) if need_x else None
    gd = torch.zeros((P, DP), dtype=acc, device=dev) if need_d else None

    def enc(p, f, width):
        return rd(F.pad(positional_encoding(p, f), (0, width - encoding_dim(f))))

    for s in range(0, P, REF_CHUNK):
        e = min(P, s + REF_CHUNK)
        x = enc(pts[s:e], L.multires, XP)
        d = enc(dirs[torch.arange(s, e, device=dev) // ppd], L.multires_views, DP)
        hs, a = [], x
        for i in range(D):
            h = rd(torch.relu(a @ T[i] + bt[i]))
            hs.append(h)
            a = torch.cat([h, x], -1) if i == skip else h
        h = hs[-1]
        rgb_f, ins_f = rd(h @ Wrgbf + brgbf), rd(h @ Winsf + binsf)
        rgb_cat = torch.cat([rgb_f, d], -1)
        rgb_h = rd(torch.relu(rgb_cat @ Wrh + brh))
        ins_h = rd(torch.relu(ins_f @ Wih + bih))
        hh = torch.cat([rgb_h, ins_h], -1)

        gc = g[s:e].to(acc)
        gb = rd(F.pad(gc, (0, CP - C)))
        dWout += torch.cat([hh, h], -1).T @ gb
        db[L.boff_o:L.boff_o + C] += gc.sum(0)
        d_hh = gb @ Wout[:W].T
        d_rgb_h = rd(d_hh[:, :HW] * (rgb_h > 0))
        d_ins_h = rd(d_hh[:, HW:] * (ins_h > 0))
        # the instance branch: its own dW/db, no cotangent into the trunk
        dWih += ins_f.T @ d_ins_h
        db[L.boff_ih:L.boff_ih + HW] += d_ins_h.sum(0)
        d_ins_f = rd(d_ins_h @ Wih.T)
        dWinsf += h.T @ d_ins_f
        db[L.boff_insf:L.boff_insf + W] += d_ins_f.sum(0)
        # the rgb branch
        dWrh += rgb_cat.T @ d_rgb_h
        db[L.boff_rh:L.boff_rh + HW] += d_rgb_h.sum(0)
        d_rgb_cat = d_rgb_h @ Wrh.T
        if need_d:
            gd[s:e] = d_rgb_cat[:, W:]
        d_rgb_f = rd(d_rgb_cat[:, :W])
        dWrgbf += h.T @ d_rgb_f
        db[L.boff_rgbf:L.boff_rgbf + W] += d_rgb_f.sum(0)
        # the trunk, from the density head and the rgb branch
        dh = gb @ Wout[W:].T + d_rgb_f @ Wrgbf.T
        for i in range(D - 1, -1, -1):
            dy = rd(dh * (hs[i] > 0))
            a_in = x if i == 0 else (torch.cat([hs[skip], x], -1) if i == skip + 1
                                     else hs[i - 1])
            dT[i] += a_in.T @ dy
            db[L.boff_t + i * W:L.boff_t + (i + 1) * W] += dy.sum(0)
            if i == 0:
                if need_x:
                    gx[s:e] += dy @ T[0].T
                break
            d_full = dy @ T[i].T
            dh = d_full[:, :W]
            if i == skip + 1 and need_x:
                gx[s:e] += d_full[:, W:]
    return FieldGrads(dw, db, gx, gd)


def unpack_grads(packed: PackedField, dw: torch.Tensor, db: torch.Tensor):
    """Gradients in the packed layouts -> one per weight of packed.field,
    in param_names order: padding rows are dropped and the output block
    splits back into rgb_linear, ins_linear and density_linear."""
    L = layout(packed)
    D, W, HW, XP, DP, CP, C = L.D, L.W, L.W // 2, L.XP, L.DP, L.CP, L.C
    pos_ch, view_ch = encoding_dim(L.multires), encoding_dim(L.multires_views)

    def mat(off, k, n):
        return dw[off:off + k * n].view(k, n)

    def bias(off, n):
        return db[off:off + n]

    g = {}
    for i in range(D):
        t = mat(L.off_t[i], L.k_in(i), W)
        if i == 0:
            t = t[:pos_ch]
        elif i == L.skip + 1:
            t = torch.cat([t[:W], t[W:W + pos_ch]])
        g[f"mlps.{i}.weight"] = t.T
        g[f"mlps.{i}.bias"] = bias(L.boff_t + i * W, W)
    g["rgb_feature_linear.weight"] = mat(L.off_rgbf, W, W).T
    g["rgb_feature_linear.bias"] = bias(L.boff_rgbf, W)
    rh = mat(L.off_rh, W + DP, HW)
    g["rgb_feature_linears.0.weight"] = torch.cat([rh[:W], rh[W:W + view_ch]]).T
    g["rgb_feature_linears.0.bias"] = bias(L.boff_rh, HW)
    g["ins_feature_linear.weight"] = mat(L.off_insf, W, W).T
    g["ins_feature_linear.bias"] = bias(L.boff_insf, W)
    g["ins_feature_linears.0.weight"] = mat(L.off_ih, W, HW).T
    g["ins_feature_linears.0.bias"] = bias(L.boff_ih, HW)
    out, bo = mat(L.off_out, 2 * W, CP), bias(L.boff_o, CP)
    g["rgb_linear.weight"] = out[:HW, 0:3].T
    g["rgb_linear.bias"] = bo[0:3]
    g["ins_linear.weight"] = out[HW:W, 4:C].T
    g["ins_linear.bias"] = bo[4:C]
    g["density_linear.weight"] = out[W:, 3:4].T
    g["density_linear.bias"] = bo[3:4]
    return tuple(g[name].contiguous() for name in param_names(packed.field.cfg))


# ---- kernel wrappers ----------------------------------------------------------

def _check(packed: PackedField, pts: torch.Tensor, dirs: torch.Tensor, g=None):
    cfg = packed.field.cfg
    build_of(packed, "field kernels")
    P = pts.shape[0]
    for name, t, shape in (("pts", pts, (P, 3)), ("dirs", dirs, (dirs.shape[0], 3)),
                           ("g", g, (P, cfg.ins_num + 5))):
        if t is None:
            continue
        if t.device != pts.device or packed.w.device != pts.device:
            raise ValueError(f"field kernels: {name} on {t.device}, pts on {pts.device}, "
                             f"weights on {packed.w.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"field kernels: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"field kernels: {name} must be a contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    if P < 1:
        raise ValueError("field kernels: no points")
    check_kernel_shape(cfg, "field kernels")


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({lib.field_error_string(rc).decode()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def field_forward(params: Params, pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """K1: raw [..., C] fp32 for pts [..., 3] and viewdirs of pts' shape or
    [..., 1, 3]."""
    if _device_kind(pts) == "cpu":
        return field_forward_ref(_as_field(params), pts, viewdirs)
    from dmnerf_torch.kernels.build import load_field
    packed = params if isinstance(params, PackedField) else pack_field(params, slabs=False)
    pf, dirs, ppd = flatten_inputs(pts, viewdirs)
    _check(packed, pf, dirs)
    P, C = pf.shape[0], packed.field.cfg.ins_num + 5
    raw = torch.empty((P, C), dtype=torch.float32, device=pts.device)
    lib = load_field()
    name = "field_forward" + build_of(packed, "field kernels")
    rc = getattr(lib, name)(pf.data_ptr(), dirs.data_ptr(), P, ppd, packed.w.data_ptr(),
                            packed.b.data_ptr(), packed.meta.ctypes.data, len(packed.meta),
                            raw.data_ptr(), _stream(pts))
    _raise_on(rc, lib, name)
    LAUNCHES[name] += 1
    return raw.reshape(*pts.shape[:-1], C)


def field_backward(packed: PackedField, pts: torch.Tensor, dirs: torch.Tensor, ppd: int,
                   g: torch.Tensor, need_x: bool = False, need_d: bool = False) -> FieldGrads:
    """K2: the gradients of raw = field(pts, dirs) for the cotangent g
    [P, C] (flat inputs as flatten_inputs gives them)."""
    if _device_kind(pts) == "cpu":
        return field_backward_ref(packed, pts, dirs, ppd, g, need_x, need_d)
    from dmnerf_torch.kernels.build import load_field
    _check(packed, pts, dirs, g)
    L = layout(packed)
    lib = load_field()
    suffix = build_of(packed, "field kernels")
    aw, yw = ctypes.c_int(), ctypes.c_int()
    _raise_on(lib.field_scratch_widths(packed.meta.ctypes.data, len(packed.meta),
                                       ctypes.byref(aw), ctypes.byref(yw)),
              lib, "field_scratch_widths")
    P = pts.shape[0]
    tile = getattr(lib, "field_tile_rows" + suffix)()
    P_pad = -(-P // tile) * tile
    n_split = -(-P_pad // PSPLIT)
    dev, f32 = pts.device, torch.float32
    act = torch.empty((P_pad, aw.value), dtype=packed.w.dtype, device=dev)
    dys = torch.empty((P_pad, yw.value), dtype=packed.w.dtype, device=dev)
    gx = torch.empty((P_pad, L.XP), dtype=f32, device=dev) if need_x else None
    gd = torch.empty((P_pad, L.DP), dtype=f32, device=dev) if need_d else None
    n_w, n_b = packed.w.numel(), packed.b.numel()
    partial_w = torch.zeros((n_split, n_w), dtype=f32, device=dev)
    partial_b = torch.zeros((n_split, n_b), dtype=f32, device=dev)
    dw = torch.empty(n_w, dtype=f32, device=dev)
    db = torch.empty(n_b, dtype=f32, device=dev)
    name = "field_backward" + suffix
    core = k2_core(L, packed.w.dtype)
    scratch = [act.data_ptr(), aw.value, dys.data_ptr(), yw.value]
    entry = name
    if core == "wgmma":
        # the ReLU masks of each tile, by words per thread
        mask_w = lib.field_mask_words(packed.meta.ctypes.data, len(packed.meta))
        masks = torch.empty((P_pad // tile, mask_w, 256), dtype=torch.int32, device=dev)
        scratch += [masks.data_ptr(), mask_w]
        entry = "field_backward_wgmma"
    rc = getattr(lib, entry)(
        pts.data_ptr(), dirs.data_ptr(), P, ppd, packed.w.data_ptr(), packed.b.data_ptr(),
        packed.meta.ctypes.data, len(packed.meta), g.data_ptr(), *scratch,
        gx.data_ptr() if need_x else None, gd.data_ptr() if need_d else None,
        partial_w.data_ptr(), n_w, partial_b.data_ptr(), n_b, PSPLIT,
        dw.data_ptr(), db.data_ptr(), _stream(pts))
    _raise_on(rc, lib, entry)
    LAUNCHES[name] += 1
    if core:
        K2_CORES[core] += 1
    return FieldGrads(dw, db, gx[:P] if need_x else None, gd[:P] if need_d else None)


def _pe_vjp(x: torch.Tensor, g_enc: torch.Tensor, multires: int) -> torch.Tensor:
    """The cotangent of x [N, 3] for the cotangent g_enc [N, ch] of
    positional_encoding(x, multires)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        (gx,) = torch.autograd.grad(positional_encoding(xr, multires), xr, g_enc)
    return gx


class FusedField(torch.autograd.Function):
    """raw = field(pts, viewdirs) through K1, differentiated through K2.

    apply(packed, pts, viewdirs, *params): params are packed.field's
    weights in param_names order (models/fields.field_tensors: its
    parameters, or tensors gathered from a model-sharded field), so autograd
    hands their gradients back through them. The encoding cotangents are computed only when pts or
    viewdirs require a gradient (a null pointer in the kernel skips them);
    they are rounded to the compute dtype, as the TPU kernel stores them, and
    carried through the positional encoding."""

    @staticmethod
    def forward(ctx, packed, pts, viewdirs, *params):
        ctx.packed = packed
        ctx.save_for_backward(pts, viewdirs)
        return field_forward(packed, pts, viewdirs)

    @staticmethod
    def backward(ctx, g):
        packed = ctx.packed
        pts, viewdirs = ctx.saved_tensors
        need_x, need_d = ctx.needs_input_grad[1], ctx.needs_input_grad[2]
        pf, dirs, ppd = flatten_inputs(pts, viewdirs)
        grads = field_backward(packed, pf.contiguous(), dirs.contiguous(), ppd,
                               g.reshape(pf.shape[0], -1).contiguous(), need_x, need_d)
        cfg = packed.field.cfg
        dt = cfg.compute_dtype
        d_pts = d_vd = None
        if need_x:
            d_pts = _pe_vjp(pf, grads.gx[:, :cfg.pos_ch].to(dt).to(pf.dtype),
                            cfg.multires).reshape(pts.shape)
        if need_d:
            per_pt = dirs.repeat_interleave(ppd, 0) if ppd > 1 else dirs
            d_dir = _pe_vjp(per_pt, grads.gd[:, :cfg.view_ch].to(dt).to(dirs.dtype),
                            cfg.multires_views)
            d_vd = d_dir.reshape(-1, ppd, 3).sum(1).reshape(viewdirs.shape)
        return (None, d_pts, d_vd, *unpack_grads(packed, grads.dw, grads.db))


def _field_fn(cfg: FieldConfig, trainable: bool):
    def field(params, pts, viewdirs):
        module = _as_field(params)
        if module.cfg != cfg:
            raise ValueError("field kernels: params were built for another FieldConfig")
        if not trainable:
            return field_forward(params, pts, viewdirs)
        packed = params if isinstance(params, PackedField) else pack_field(params, slabs=False)
        return FusedField.apply(packed, pts, viewdirs, *field_tensors(module))
    return field


def make_pallas_field(cfg: FieldConfig):
    """Forward-only field for eval paths: field(params, pts [R,S,3],
    viewdirs [R,1,3]) -> raw [R,S,C] through K1 (the plain version on the
    CPU). params: a DMNeRFField built with cfg, or its PackedField."""
    return _field_fn(cfg, trainable=False)


def make_trainable_pallas_field(cfg: FieldConfig):
    """The differentiable field of the training step: the same call as
    make_pallas_field, through FusedField (K1 forward, K2 backward). The
    weights are packed on every call, since the fp32 masters change every
    step."""
    return _field_fn(cfg, trainable=True)
