"""Fused field + composite for the eval render and edit paths: CUDA kernels
K3, K4 and K5, the weight packing of every field kernel, and the limits of
the shapes the kernels take.

Port of dmnerf_tpu/ops/pallas/render_field.py. Three kernels in
csrc/render_field.cu replace the TPU kernel `_composite_kernel`:

- render_field_sigma (K4, heads="sigma"): trunk + density head, then the
  compositing weights [R, S]. The coarse pass needs nothing else: at eval its
  weights only drive importance sampling.
- render_field_all (K3, heads="all"): the whole field, then per ray rgb [R,3],
  depth [R] and instance logits [R,K+1]. The raw [R,S,C] tensor never reaches
  device memory.
- render_field_ins (K5, heads="ins"): trunk, density and the instance branch
  (no view directions, no rgb branch), then per ray the instance logits
  [R,K+1]. The edit path's accumulated-label passes composite nothing else.

The bf16 K3, K4 and K5 run the field through K1's tile forward (csrc/field_tile.cuh
on the mma.sync core of csrc/field_core.cuh): a block takes a few whole rays
and walks their points in 128-point tiles, then composites each ray's rows
in sample order. check_kernel_shape holds every field kernel's wrapper
(K1-K5) to the widths the CUDA sources take: up to 256 wide, and up to
ins_num 123 at any width.

Beside each kernel is its plain PyTorch version (render_field_sigma_ref /
render_field_all_ref / render_field_ins_ref): the field module plus
core/rendering's compositing, with bf16 operands upcast to fp32 for every
matmul (f32: fp32 throughout), so the products are exact and only the order
of summation differs from the kernel. A wrapper takes the plain version for CPU tensors only; for
a CUDA tensor it launches the kernel or raises. LAUNCHES counts the launches
of each kernel.

Every field kernel (K1-K5) has a bf16 build (the deployed precision) and an
f32 build (precision f32: fp32 weights, activations, products and sums, on
64-point tiles); the wrappers pick the build from the packed weights' dtype
(build_of) and count its launches under its own key. The f32 builds of K3,
K4 and K5 are a kernel of their own (csrc/composite_f32.cuh) and read the
weights as pack_field's slabs: each 8-row slab of a layer contiguous, hi and
lo halves, in the order its wgmma read them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from dmnerf_torch.core.rendering import alpha_weights, composite, sample_dists
from dmnerf_torch.core.sampling import sample_pdf
from dmnerf_torch.models.fields import DMNeRFField, FieldConfig

# launches of each kernel since the last reset (the CPU plain path adds none)
LAUNCHES: Dict[str, int] = {"render_field_sigma": 0, "render_field_all": 0,
                            "render_field_ins": 0, "render_field_sigma_f32": 0,
                            "render_field_all_f32": 0, "render_field_ins_f32": 0}
# the suffix of each build's C entry points and LAUNCHES keys, by the dtype of
# the packed weights
BUILDS = {torch.bfloat16: "", torch.float32: "_f32"}

MAX_DEPTH = 16          # trunk layers the kernel's Meta block describes
MAX_WIDTH = 256         # the widest layer the kernels' register tiles hold (csrc MAXW)
MAX_OUT = 128           # the widest output layer, 4+ins_num+1 padded to 16 (csrc MAXCP)
_ALIGN = 128            # elements between packed matrices (256 bytes in bf16)
N_SLAB_OFFS = MAX_DEPTH + 8   # slab offsets after the Meta ints (csrc f32c::MAXSEG)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _ru(x: int, m: int) -> int:
    return -(-x // m) * m


class PackedField(NamedTuple):
    """A field's weights laid out for the kernel.

    w: [n] in the compute dtype (bf16 or f32, which picks the kernels'
       build) — every matrix as [in, out] row-major, in-widths padded with
       zero rows to a multiple of 16:
         t0 [XP, W]; t_i [W, W], except t_{skip+1} [W + XP, W] (rows W: face
         the skip input x); rgb_feat [W, W]; rgb_hidden [W + DP, W/2] (rows W:
         face the view encoding); ins_feat [W, W]; ins_hidden [W, W/2];
         out [2W, CP]: rows 0:W/2 rgb_out -> cols 0:3, rows W/2:W ins_out ->
         cols 4:C, rows W:2W density -> col 3.
    b: fp32 [n] — trunk biases [D, W], rgb_feat [W], rgb_hidden [W/2],
       ins_feat [W], ins_hidden [W/2], out [CP] = [rgb_out, density, ins_out, 0].
    meta: int32, the kernel's `Meta` struct (dims, then element offsets).
    field: the module the weights came from (the CPU path runs it).
    slabs: the f32 composites' weights (K3, K4, K5 f32; None for bf16 and
       where pack_field was asked for none), fp32 — per segment of the
       plan (composite_segments), per 8-row slab of its [rows, n] matrix,
       the hi block then the lo block (hi = tf32(w) rounded to nearest, ties
       away from zero; lo = w - hi, exact), each [2, n/8, 8, 4]: word (c, g,
       r, q) holds row 4c + q of the slab, column 8g + r (the no-swizzle
       K-major layout that wgmma reads, csrc/composite_f32.cuh). The
       segments (_composite_segments) are the trunk's blocks, then rgb_feat,
       rgb_hidden, out's density rows [W:2W, 0:8], ins_feat, ins_hidden,
       out's rgb rows [0:W/2, 0:8] and its instance rows [W/2:W, :].
    slab_meta: int32, meta followed by each segment's word offset in slabs
       (N_SLAB_OFFS, -1 past the last).
    """
    field: DMNeRFField
    w: torch.Tensor
    b: torch.Tensor
    meta: np.ndarray
    slabs: Optional[torch.Tensor] = None
    slab_meta: Optional[np.ndarray] = None


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on fp32 x: round to 10 mantissa bits, to nearest,
    ties away from zero (a carry may reach the exponent)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return (bits - ((bits >> 31) << 32)).to(torch.int32).view(torch.float32)


def _composite_segments(cfg: FieldConfig):
    """The f32 composites' weight plan for heads="all", in the order the
    kernel consumes it (csrc/composite_f32.cuh::plan_heads; K4 and K5 take
    a subset): (name, rows, n) per segment, an [rows, n] block of a packed
    [in, out] matrix."""
    D, W, HW = cfg.netdepth, cfg.netwidth, cfg.netwidth // 2
    XP, DP, CP = _ru(cfg.pos_ch, 16), _ru(cfg.view_ch, 16), _ru(cfg.ins_num + 5, 16)
    segs = [("t0", XP, W)]
    for i in range(1, D):
        segs.append((f"t{i}", W, W))
        if i == cfg.skip + 1:
            segs.append((f"t{i}x", XP, W))
    return segs + [("rgb_feat", W, W), ("rgb_hidden", W + DP, HW), ("density", W, 8),
                   ("ins_feat", W, W), ("ins_hidden", W, HW), ("rgb_out", HW, 8),
                   ("ins_out", HW, CP)]


def _slab_block(m: torch.Tensor) -> torch.Tensor:
    """[rows, n] fp32 -> its slabs, flat: per 8 rows, hi then lo, each as
    [2, n/8, 8, 4] (PackedField.slabs)."""
    rows, n = m.shape
    hi = rna_tf32(m)
    x = torch.stack([hi, m - hi]).reshape(2, rows // 8, 2, 4, n // 8, 8)
    return x.permute(1, 0, 2, 4, 5, 3).reshape(-1)


def pack_field(field: DMNeRFField, slabs: bool = True) -> PackedField:
    """The weights of field laid out for the kernels; slabs: the f32
    composites' slabs too (f32 fields only; the training kernels K1/K2 need
    none)."""
    cfg = field.cfg
    D, W, K1 = cfg.netdepth, cfg.netwidth, cfg.ins_num + 1
    if D > MAX_DEPTH:
        raise ValueError(f"netdepth {D} > {MAX_DEPTH}: the kernel's layout has no room")
    XP, DP = _ru(cfg.pos_ch, 16), _ru(cfg.view_ch, 16)
    C = 4 + K1
    CP = _ru(C, 16)

    def wt(lin):                       # nn.Linear [out, in] -> [in, out] fp32
        return lin.weight.detach().float().T

    def pad_rows(m, rows):
        return F.pad(m, (0, 0, 0, rows - m.shape[0]))

    with torch.no_grad():
        trunk = [pad_rows(wt(field.mlps[0]), XP)]
        for i in range(1, D):
            m = wt(field.mlps[i])
            if i == cfg.skip + 1:
                m = torch.cat([m[:W], pad_rows(m[W:], XP)])
            trunk.append(m)
        rh = wt(field.rgb_feature_linears[0])
        rh = torch.cat([rh[:W], pad_rows(rh[W:], DP)])
        out = torch.zeros(2 * W, CP, device=rh.device)
        out[0:W // 2, 0:3] = wt(field.rgb_linear)
        out[W // 2:W, 4:C] = wt(field.ins_linear)
        out[W:2 * W, 3:4] = wt(field.density_linear)
        mats = trunk + [wt(field.rgb_feature_linear), rh, wt(field.ins_feature_linear),
                        wt(field.ins_feature_linears[0]), out]

        offs, n = [], 0
        for m in mats:
            offs.append(n)
            n = _ru(n + m.numel(), _ALIGN)
        w = torch.zeros(n, dtype=cfg.compute_dtype, device=rh.device)
        for o, m in zip(offs, mats):
            w[o:o + m.numel()] = m.reshape(-1).to(cfg.compute_dtype)

        bo = torch.zeros(CP, device=rh.device)
        bo[0:3] = field.rgb_linear.bias.detach().float()
        bo[3:4] = field.density_linear.bias.detach().float()
        bo[4:C] = field.ins_linear.bias.detach().float()
        biases = ([torch.cat([l.bias.detach().float() for l in field.mlps])]
                  + [l.bias.detach().float() for l in (
                      field.rgb_feature_linear, field.rgb_feature_linears[0],
                      field.ins_feature_linear, field.ins_feature_linears[0])]
                  + [bo])
        boffs = np.cumsum([0] + [x.numel() for x in biases[:-1]]).tolist()
        b = torch.cat(biases)

    meta = ([D, W, cfg.skip, XP, DP, CP, C, cfg.multires, cfg.multires_views]
            + offs[:D] + [0] * (MAX_DEPTH - D) + offs[D:] + boffs)
    packed = PackedField(field, w, b, np.asarray(meta, np.int32))
    if slabs and cfg.compute_dtype == torch.float32:
        with torch.no_grad():
            packed = _with_slabs(packed, trunk, mats[D:], out)
    return packed


def _with_slabs(packed: PackedField, trunk, heads, out) -> PackedField:
    """packed with the f32 composites' slabs of the [in, out] matrices
    trunk, heads (rgb_feat, rgb_hidden, ins_feat, ins_hidden) and out."""
    W, HW = packed.field.cfg.netwidth, packed.field.cfg.netwidth // 2
    mats = {f"t{i}": m[:W] if i else m for i, m in enumerate(trunk)}
    mats.update({f"t{i}x": m[W:] for i, m in enumerate(trunk) if i and m.shape[0] > W})
    mats.update(zip(("rgb_feat", "rgb_hidden", "ins_feat", "ins_hidden"), heads))
    mats.update(density=out[W:2 * W, 0:8], rgb_out=out[0:HW, 0:8], ins_out=out[HW:W])
    blocks, offs, n = [], [], 0
    for name, rows, cols in _composite_segments(packed.field.cfg):
        m = mats[name].float()
        if tuple(m.shape) != (rows, cols):
            raise AssertionError(f"pack_field: segment {name} is {tuple(m.shape)}, the plan "
                                 f"reads {(rows, cols)}")
        offs.append(n)
        blocks.append(_slab_block(m))
        n += blocks[-1].numel()
    meta = np.concatenate([packed.meta, np.asarray(offs + [-1] * (N_SLAB_OFFS - len(offs)),
                                                   np.int32)])
    return packed._replace(slabs=torch.cat(blocks), slab_meta=meta)


def with_slabs(packed: PackedField) -> PackedField:
    """packed, with the f32 composites' slabs if it has none."""
    if packed.slabs is not None or packed.w.dtype != torch.float32:
        return packed
    return pack_field(packed.field)


Params = Union[DMNeRFField, PackedField]


def pack_params(params: Dict[str, Params]) -> Dict[str, PackedField]:
    """{"coarse": field, "fine": field} -> the same keys, packed once."""
    return {k: v if isinstance(v, PackedField) else pack_field(v)
            for k, v in params.items()}


def _as_field(params: Params) -> DMNeRFField:
    return params.field if isinstance(params, PackedField) else params


# ---- plain PyTorch versions -------------------------------------------------

def render_field_sigma_ref(field: DMNeRFField, pts: torch.Tensor, z: torch.Tensor,
                           rays_d: torch.Tensor) -> torch.Tensor:
    """weights [R, S] from pts [R,S,3], z [R,S], rays_d [R,3]."""
    sigma = field.density(pts)[..., 0]
    return alpha_weights(sigma, sample_dists(z, rays_d))


def render_field_all_ref(field: DMNeRFField, pts: torch.Tensor, viewdirs: torch.Tensor,
                         z: torch.Tensor, rays_d: torch.Tensor):
    """(rgb [R,3], depth [R], ins_logits [R,K+1]) from pts [R,S,3],
    viewdirs [R,1,3], z [R,S], rays_d [R,3]."""
    out = composite(field(pts, viewdirs), z, rays_d, keep_air=True)
    return out.rgb, out.depth, out.ins_logits


def render_field_ins_ref(field: DMNeRFField, pts: torch.Tensor, z: torch.Tensor,
                         rays_d: torch.Tensor) -> torch.Tensor:
    """ins_logits [R,K+1] from pts [R,S,3], z [R,S], rays_d [R,3]."""
    sigma, ins = field.instance(pts)
    weights = alpha_weights(sigma[..., 0], sample_dists(z, rays_d))
    return torch.sum(weights[..., None] * ins, dim=-2)


# ---- kernel wrappers ----------------------------------------------------------

def check_kernel_shape(cfg: FieldConfig, who: str) -> None:
    """Raise ValueError naming the first limit of the CUDA field kernels
    (K1-K5) that a field of `cfg` breaks: what csrc's read_meta accepts."""
    W, HW = cfg.netwidth, cfg.netwidth // 2
    XP, DP, CP = _ru(cfg.pos_ch, 16), _ru(cfg.view_ch, 16), _ru(cfg.ins_num + 5, 16)
    limits = (
        (W % 32 == 0, f"netwidth {W} must be a multiple of 32"),
        (W <= MAX_WIDTH, f"netwidth {W} must be at most {MAX_WIDTH}"),
        (cfg.netdepth <= MAX_DEPTH, f"netdepth {cfg.netdepth} must be at most {MAX_DEPTH}"),
        (XP <= W, f"the position encoding padded to {XP} must be at most netwidth {W}"),
        (DP <= HW, f"the view encoding padded to {DP} must be at most netwidth/2 = {HW}"),
        (CP <= MAX_OUT, f"the output columns 4+ins_num+1 padded to {CP} (ins_num "
                        f"{cfg.ins_num}) must be at most {MAX_OUT}"),
    )
    for ok, limit in limits:
        if not ok:
            raise ValueError(f"{who}: {limit}")


def build_of(packed: PackedField, who: str) -> str:
    """The suffix of the kernels' build for packed's weights: "" (bf16) or
    "_f32"."""
    if packed.w.dtype not in BUILDS:
        raise TypeError(f"{who}: no kernel build for weights of {packed.w.dtype} "
                        "(bf16 or float32)")
    return BUILDS[packed.w.dtype]


def _check(packed: PackedField, pts, z, rays_d, viewdirs=None):
    cfg = packed.field.cfg
    build_of(packed, "render_field")
    dev = pts.device
    R, S = z.shape

    def need(name, t, shape):
        if t.device != dev or packed.w.device != dev:
            raise ValueError(f"render_field: {name} on {t.device}, pts on {dev}, "
                             f"weights on {packed.w.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"render_field: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"render_field: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"render_field: {name} must be contiguous")

    need("pts", pts, (R, S, 3))
    need("z", z, (R, S))
    need("rays_d", rays_d, (R, 3))
    if viewdirs is not None:
        need("viewdirs", viewdirs, (R, 1, 3))
    if R < 1 or S < 1:
        raise ValueError(f"render_field: empty input (R={R}, S={S})")
    check_kernel_shape(cfg, "render_field")


def _weights(packed: PackedField):
    """(the build's LAUNCHES suffix, its weights, its meta): the bf16 build
    reads w and meta, the f32 one slabs and slab_meta."""
    build = build_of(packed, "render_field")
    if build == "_f32":
        return build, packed.slabs, packed.slab_meta
    return build, packed.w, packed.meta


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"render_field: no path for device {t.device}")
    return t.device.type


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({lib.render_field_error_string(rc).decode()})")


def render_field_sigma(params: Params, pts: torch.Tensor, z: torch.Tensor,
                       rays_d: torch.Tensor) -> torch.Tensor:
    """K4: compositing weights [R, S] (heads="sigma")."""
    if _device_kind(pts) == "cpu":
        return render_field_sigma_ref(_as_field(params), pts, z, rays_d)
    from dmnerf_torch.kernels.build import load_render_field
    packed = with_slabs(params if isinstance(params, PackedField) else pack_field(params))
    _check(packed, pts, z, rays_d)
    R, S = z.shape
    dists = sample_dists(z, rays_d).contiguous()
    weights = torch.empty((R, S), dtype=torch.float32, device=pts.device)
    lib = load_render_field()
    build, w, meta = _weights(packed)
    name = "render_field_sigma" + build
    rc = getattr(lib, name)(
        pts.data_ptr(), z.data_ptr(), dists.data_ptr(), R, S,
        w.data_ptr(), packed.b.data_ptr(), meta.ctypes.data, len(meta), weights.data_ptr(),
        torch.cuda.current_stream(pts.device).cuda_stream)
    _raise_on(rc, lib, name)
    LAUNCHES[name] += 1
    return weights


def render_field_all(params: Params, pts: torch.Tensor, viewdirs: torch.Tensor,
                     z: torch.Tensor, rays_d: torch.Tensor):
    """K3: (rgb [R,3], depth [R], ins_logits [R,K+1]) (heads="all")."""
    if _device_kind(pts) == "cpu":
        return render_field_all_ref(_as_field(params), pts, viewdirs, z, rays_d)
    from dmnerf_torch.kernels.build import load_render_field
    packed = with_slabs(params if isinstance(params, PackedField) else pack_field(params))
    _check(packed, pts, z, rays_d, viewdirs)
    R, S = z.shape
    K1 = packed.field.cfg.ins_num + 1
    dists = sample_dists(z, rays_d).contiguous()
    out = dict(device=pts.device, dtype=torch.float32)
    rgb, depth = torch.empty((R, 3), **out), torch.empty((R,), **out)
    ins = torch.empty((R, K1), **out)
    lib = load_render_field()
    build, w, meta = _weights(packed)
    name = "render_field_all" + build
    rc = getattr(lib, name)(
        pts.data_ptr(), viewdirs.data_ptr(), z.data_ptr(), dists.data_ptr(), R, S,
        w.data_ptr(), packed.b.data_ptr(), meta.ctypes.data, len(meta), rgb.data_ptr(),
        depth.data_ptr(), ins.data_ptr(),
        torch.cuda.current_stream(pts.device).cuda_stream)
    _raise_on(rc, lib, name)
    LAUNCHES[name] += 1
    return rgb, depth, ins


def render_field_ins(params: Params, pts: torch.Tensor, z: torch.Tensor,
                     rays_d: torch.Tensor) -> torch.Tensor:
    """K5: instance logits [R,K+1] (heads="ins")."""
    if _device_kind(pts) == "cpu":
        return render_field_ins_ref(_as_field(params), pts, z, rays_d)
    from dmnerf_torch.kernels.build import load_render_field
    packed = with_slabs(params if isinstance(params, PackedField) else pack_field(params))
    _check(packed, pts, z, rays_d)
    R, S = z.shape
    dists = sample_dists(z, rays_d).contiguous()
    ins = torch.empty((R, packed.field.cfg.ins_num + 1), dtype=torch.float32,
                      device=pts.device)
    lib = load_render_field()
    build, w, meta = _weights(packed)
    name = "render_field_ins" + build
    rc = getattr(lib, name)(
        pts.data_ptr(), z.data_ptr(), dists.data_ptr(), R, S,
        w.data_ptr(), packed.b.data_ptr(), meta.ctypes.data, len(meta), ins.data_ptr(),
        torch.cuda.current_stream(pts.device).cuda_stream)
    _raise_on(rc, lib, name)
    LAUNCHES[name] += 1
    return ins


# ---- the JAX package's entry points -------------------------------------------

def make_render_field(cfg: FieldConfig, heads: str = "all"):
    """heads="all":   rf(params, pts [R,S,3], viewdirs [R,1,3], z [R,S],
                         rays_d [R,3]) -> (rgb [R,3], depth [R], ins_logits [R,K+1])
    heads="sigma": rf(params, pts, z, rays_d) -> weights [R,S]
    heads="ins":   rf(params, pts, z, rays_d) -> ins_logits [R,K+1]
    params: a DMNeRFField built with `cfg`, or its PackedField."""
    if heads not in ("all", "sigma", "ins"):
        raise ValueError(f"unknown heads {heads!r}")

    def checked(params):
        if _as_field(params).cfg != cfg:
            raise ValueError("render_field: params were built for another FieldConfig")
        return params

    if heads == "sigma":
        return lambda params, pts, z, rays_d: render_field_sigma(
            checked(params), pts, z, rays_d)
    if heads == "ins":
        return lambda params, pts, z, rays_d: render_field_ins(
            checked(params), pts, z, rays_d)
    return lambda params, pts, viewdirs, z, rays_d: render_field_all(
        checked(params), pts, viewdirs, z, rays_d)


def make_fused_chunk_renderer(cfg: FieldConfig, n_importance: int):
    """render_chunk(params, rays_o [R,3], rays_d [R,3], z_vals_coarse [R,S])
    -> (rgb [R,3], ins [R,K] sigmoid with the air channel dropped, depth [R]).

    The deterministic coarse->fine eval pipeline with both field evaluations
    fused with their composites: K4 for the coarse weights, det sample_pdf and
    the sorted z-union in PyTorch, then K3."""
    coarse_rf = make_render_field(cfg, heads="sigma")
    fine_rf = make_render_field(cfg, heads="all")

    def render_chunk(params, rays_o, rays_d, z_vals_coarse):
        z_c = z_vals_coarse.contiguous()
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        pts_c = rays_o[:, None, :] + rays_d[:, None, :] * z_c[:, :, None]
        w_c = coarse_rf(params["coarse"], pts_c, z_c, rays_d)

        z_mid = 0.5 * (z_c[:, 1:] + z_c[:, :-1])
        z_samples = sample_pdf(z_mid, w_c[:, 1:-1], n_importance, det=True)
        z_fine, _ = torch.sort(torch.cat([z_c, z_samples], dim=-1), dim=-1)

        pts_f = rays_o[:, None, :] + rays_d[:, None, :] * z_fine[:, :, None]
        rgb, depth, ins_logits = fine_rf(params["fine"], pts_f, viewdirs[:, None, :],
                                         z_fine, rays_d)
        return rgb, torch.sigmoid(ins_logits)[:, :-1], depth

    return render_chunk
