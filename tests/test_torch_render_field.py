"""dmnerf_torch/kernels/render_field: the plain versions of kernels K3/K4 vs
the JAX package's Pallas kernel (interpret mode on the CPU) and vs
apply_field + composite, and those of K1/K3/K4/K5 at the flagship width with
ins_num 64 and at the replica64 stress scene's width 128 with ins_num 65;
the kernel's weight packing in bf16 and in f32, checked by an emulation that
reads the packed buffers at the offsets the CUDA source reads and walks K4's
rays in tiles as its blocks do; and the wrappers' dispatch and validation,
with the shape limits every field kernel shares.
The kernels themselves run on a card only: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmnerf_tpu.core import rendering as jrend
from dmnerf_tpu.models import fields as jf
from dmnerf_tpu.ops.pallas import render_field as jrf
from dmnerf_tpu.ops.pallas.field_kernels import make_pallas_field as jax_pallas_field
from dmnerf_torch.core.encoding import positional_encoding
from dmnerf_torch.core.rendering import alpha_weights, sample_dists
from dmnerf_torch.kernels import render_field as krf
from dmnerf_torch.models import fields as tf
from dmnerf_torch.models.convert import state_dict_from_jax

SMALL = dict(netdepth=3, netwidth=32, multires=4, multires_views=2, ins_num=4, skip=1)
# the flagship field with 64 instance slots: 4+64+1 output columns pad to CP
# 80, past the 64 that one register tile of the CUDA kernels' output holds
WIDE64 = dict(netdepth=8, netwidth=256, multires=10, multires_views=4, ins_num=64, skip=4)
# configs/stress/replica64_stress.txt: width 128, and the replica loader's
# ins_num is the palette's length, 64 objects + 1, so CP 80 > netwidth/2
STRESS64 = dict(netdepth=8, netwidth=128, multires=10, multires_views=4, ins_num=65, skip=4)


def _field(dtype_t, seed=0, dtype_j=jnp.float32, **over):
    kw = {**SMALL, **over}
    cfg_j = jf.FieldConfig(**kw, compute_dtype=dtype_j)
    params = jf.init_field_params(jax.random.PRNGKey(seed), cfg_j)
    field = tf.DMNeRFField(tf.FieldConfig(**kw, compute_dtype=dtype_t))
    field.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return cfg_j, params, field


def _rays(R=16, S=8, seed=3):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(R, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True) \
        * rng.uniform(0.8, 1.2, (R, 1)).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 6.0, (R, S)), -1).astype(np.float32)
    pts = ro[:, None, :] + rd[:, None, :] * z[:, :, None]
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True))[:, None, :]
    return pts, vd, z, rd


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def test_sigma_ref_matches_jax_kernel_and_composite():
    """K4's plain version vs the Pallas heads='sigma' kernel (interpret,
    f32) and vs apply_field + composite.weights. The Pallas transmittance is
    exp(log(max(1-a, 1e-10)) @ tri): f32 exp/log rounding, 1e-5 abs."""
    cfg_j, params, field = _field(torch.float32)
    pts, vd, z, rd = _rays()
    got = krf.render_field_sigma_ref(field, *_t(pts, z, rd)).detach().numpy()
    kern = np.asarray(jrf.make_render_field(cfg_j, heads="sigma")(
        params, jnp.asarray(pts), jnp.asarray(z), jnp.asarray(rd)))
    raw = jf.apply_field(params, cfg_j, jnp.asarray(pts), jnp.asarray(vd))
    comp = np.asarray(jrend.composite(raw, jnp.asarray(z), jnp.asarray(rd)).weights)
    assert got.shape == (16, 8)
    np.testing.assert_allclose(got, kern, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, comp, atol=1e-5, rtol=1e-4)


def test_all_ref_matches_jax_kernel_and_composite():
    """K3's plain version vs the Pallas heads='all' kernel (interpret, f32)
    and vs apply_field + composite(keep_air): 1e-5 abs (rgb, logits; f32
    summation order and the Pallas exp/log transmittance), 1e-4 on depth
    (world units up to 6)."""
    cfg_j, params, field = _field(torch.float32, seed=1)
    pts, vd, z, rd = _rays()
    got = [x.detach().numpy() for x in krf.render_field_all_ref(field, *_t(pts, vd, z, rd))]
    kern = jrf.make_render_field(cfg_j, heads="all")(
        params, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(z), jnp.asarray(rd))
    raw = jf.apply_field(params, cfg_j, jnp.asarray(pts), jnp.asarray(vd))
    comp = jrend.composite(raw, jnp.asarray(z), jnp.asarray(rd), keep_air=True)
    K1 = SMALL["ins_num"] + 1
    assert [g.shape for g in got] == [(16, 3), (16,), (16, K1)]
    for want in (kern, (comp.rgb, comp.depth, comp.ins_logits)):
        for g, w, tol in zip(got, want, (1e-5, 1e-4, 1e-5)):
            np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=1e-4)


@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K5"])
def test_plain_versions_match_jax_at_ins_num_64(kernel):
    """The plain versions of K1 (field_forward_ref), K3, K4 and K5 at the
    flagship width with ins_num 64 vs the JAX package's Pallas kernels
    (interpret mode, f32) on 8 rays x 16 samples. Only the order of f32
    sums differs through 9 layers of width 256: 1e-4 abs and relative on raw
    and logits (a few units), 1e-5 abs on weights and rgb (in [0, 1]), 1e-4
    on depth (world units up to 6)."""
    _plain_vs_jax(kernel, WIDE64, seed=5)


@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K5"])
def test_plain_versions_match_jax_at_the_replica64_stress_shape(kernel):
    """The same at configs/stress/replica64_stress.txt's shape (width 128,
    ins_num 65: the output layer is wider than half the width), at the
    same tolerances."""
    _plain_vs_jax(kernel, STRESS64, seed=7)


def _plain_vs_jax(kernel, shape, seed):
    from dmnerf_torch.kernels import field as kf
    cfg_j, params, field = _field(torch.float32, seed=seed, **shape)
    pts, vd, z, rd = _rays(R=8, S=16, seed=6)
    tp, tv, tz, trd = _t(pts, vd, z, rd)
    jp, jv, jz, jrd = (jnp.asarray(x) for x in (pts, vd, z, rd))
    with torch.no_grad():
        if kernel == "K1":
            got = [kf.field_forward_ref(field, tp, tv)]
            want = [jax_pallas_field(cfg_j)(params, jp, jv)]
            tols = [1e-4]
        elif kernel == "K3":
            got = krf.render_field_all_ref(field, tp, tv, tz, trd)
            want = jrf.make_render_field(cfg_j, heads="all")(params, jp, jv, jz, jrd)
            tols = [1e-5, 1e-4, 1e-4]
        elif kernel == "K4":
            got = [krf.render_field_sigma_ref(field, tp, tz, trd)]
            want = [jrf.make_render_field(cfg_j, heads="sigma")(params, jp, jz, jrd)]
            tols = [1e-5]
        else:
            got = [krf.render_field_ins_ref(field, tp, tz, trd)]
            want = [jrf.make_render_field(cfg_j, heads="ins")(params, jp, jz, jrd)]
            tols = [1e-4]
    for g, w, tol in zip(got, want, tols):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=1e-4)


def _group_rays(R, S, tm):
    """render_field.cu::group_rays for K4 (one thread per ray): of 1 ..
    min(8, R), the count whose G*S points leave the smallest share of padded
    rows in their last tm-point tile (the fewest rays on a tie)."""
    best, best_pad = 1, 1.0
    for g in range(1, min(8, R) + 1):
        padded = -(-g * S // tm) * tm
        pad = (padded - g * S) / padded
        if pad < best_pad:
            best, best_pad = g, pad
    return best


def _sigma_walk(alpha, R, S, tm):
    """K4's composite_kernel on per-point alpha [R*S]: G rays per block, their
    points in tm-point tiles, one thread per ray walking its rows of each tile
    in sample order with T carried across tiles (the kernel's index math)."""
    out = torch.empty(R * S)
    G = _group_rays(R, S, tm)
    for ray0 in range(0, R, G):
        nr, q0 = min(G, R - ray0), ray0 * S
        n = nr * S
        T = [1.0] * nr
        for p0 in range(0, n, tm):
            nv = min(tm, n - p0)
            for g in range(nr):
                for i in range(max(g * S - p0, 0), min((g + 1) * S - p0, nv)):
                    a = alpha[q0 + p0 + i]
                    out[q0 + p0 + i] = a * T[g]
                    T[g] = float(torch.tensor(T[g]) * ((1.0 - a) + 1e-10))
    return out.reshape(R, S)


def _emulate(packed, pts, vd, z, rd, heads):
    """The CUDA kernel's math on the packed buffers, with the offsets read
    from packed.meta exactly as csrc/render_field.cu's Meta struct does, and
    every activation rounded to the packed dtype (bf16, or f32: not at all)."""
    m = [int(v) for v in packed.meta]
    D, W, skip, XP, DP, CP, C, F, FV = m[:9]
    off_t = m[9:9 + D]
    off_rgbf, off_rh, off_insf, off_ih, off_out = m[25:30]
    bt, brgbf, brh, binsf, bih, bo = m[30:36]
    w, b = packed.w.float(), packed.b
    tm = 128 if packed.w.dtype == torch.bfloat16 else 64    # csrc core::TM

    def mat(off, k, n):
        return w[off:off + k * n].reshape(k, n)

    def bf(t):
        return t.to(packed.w.dtype).float()

    def pe(x, f, width):
        e = positional_encoding(x, f)
        return bf(torch.nn.functional.pad(e, (0, width - e.shape[-1])))

    R, S = z.shape
    x = pe(pts.reshape(-1, 3), F, XP)
    h = bf(torch.relu(x @ mat(off_t[0], XP, W) + b[bt:bt + W]))
    for i in range(1, D):
        a = torch.cat([h, x], -1) if i == skip + 1 else h
        h = bf(torch.relu(a @ mat(off_t[i], a.shape[1], W) + b[bt + i * W:bt + (i + 1) * W]))
    dists = sample_dists(z, rd)
    if heads == "sigma":
        sigma = (h @ mat(off_out, 2 * W, CP)[W:])[:, 3] + b[bo + 3]
        alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists.reshape(-1))
        return _sigma_walk(alpha, R, S, tm)
    d = pe(vd.expand(R, S, 3).reshape(-1, 3), FV, DP)
    rgb_f = bf(h @ mat(off_rgbf, W, W) + b[brgbf:brgbf + W])
    rgb_h = bf(torch.relu(torch.cat([rgb_f, d], -1) @ mat(off_rh, W + DP, W // 2)
                          + b[brh:brh + W // 2]))
    ins_f = bf(h @ mat(off_insf, W, W) + b[binsf:binsf + W])
    ins_h = bf(torch.relu(ins_f @ mat(off_ih, W, W // 2) + b[bih:bih + W // 2]))
    raw = (torch.cat([rgb_h, ins_h, h], -1) @ mat(off_out, 2 * W, CP)
           + b[bo:bo + CP])[:, :C].reshape(R, S, C)
    wts = alpha_weights(raw[..., 3], dists)
    rgb = (wts[..., None] * torch.sigmoid(raw[..., :3])).sum(1)
    return rgb, (wts * z).sum(1), (wts[..., None] * raw[..., 4:]).sum(1)


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("over", [{}, {"netdepth": 4, "skip": 2, "ins_num": 11}])
def test_packing_emulation_matches_plain_version(over, prec):
    """pack_field's layout + the kernel's offsets reproduce the plain path,
    in each build's dtype. Both round at the same places; zero padding adds
    exact zeros, but a different f32 summation order can flip one bf16 ulp
    of an activation (2^-8 relative) that later layers carry: in bf16 2e-2
    abs at most, and the median error at f32 rounding level; in f32 nothing
    is rounded below f32, so only the summation order differs: 1e-5 abs. 70
    samples per ray put K4's rays across its tiles (7 rays per block of
    128-point tiles in bf16, 8 of 64-point tiles in f32)."""
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[prec]
    _, _, field = _field(dtype, seed=2, **over)
    packed = krf.pack_field(field)
    assert packed.w.dtype == dtype and packed.b.dtype == torch.float32
    assert len(packed.meta) == 36
    R, S = 8, 70
    tm = {"bf16": 128, "f32": 64}[prec]
    G = _group_rays(R, S, tm)
    assert G > 1 and -(-G * S // tm) > 1             # several rays and tiles per block
    pts, vd, z, rd = _t(*_rays(R=R, S=S))
    with torch.no_grad():
        pairs = [(_emulate(packed, pts, vd, z, rd, "sigma"),
                  krf.render_field_sigma_ref(field, pts, z, rd))]
        pairs += list(zip(_emulate(packed, pts, vd, z, rd, "all"),
                          krf.render_field_all_ref(field, pts, vd, z, rd)))
    for got, want in pairs:
        err = (got - want).abs()
        if prec == "bf16":
            assert err.max() <= 2e-2 and err.median() <= 1e-6, (err.max(), err.median())
        else:
            assert err.max() <= 1e-5, err.max()


def _composite_plan(slab_meta, heads):
    """csrc/composite_f32.cuh::plan_heads over pack_field's slab_meta: the
    (word offset, rows, n) of every segment the f32 build of heads reads, in
    the order it reads them."""
    m = [int(v) for v in slab_meta]
    D, W, skip, XP, DP, CP = m[:6]
    so, HW = m[36:], W // 2
    segs, k = [(so[0], XP, W)], 1
    for i in range(1, D):
        segs.append((so[k], W, W))
        k += 1
        if i == skip + 1:
            segs.append((so[k], XP, W))
            k += 1
    h = so[k:]
    if heads == "all":
        segs += [(h[0], W, W), (h[1], W + DP, HW)]
    segs.append((h[2], W, 8))
    if heads != "sigma":
        segs += [(h[3], W, W), (h[4], W, HW)]
        if heads == "all":
            segs.append((h[5], HW, 8))
        segs.append((h[6], HW, CP))
    return segs


def _field_blocks(field):
    """The [in, out] blocks of field's weights that the f32 composites'
    plan reads, in its order, from the module itself (not pack_field's
    matrices): zero rows pad the encodings, the density and rgb_out blocks
    are 8 columns wide (the density in column 3), ins_out CP wide (the
    logits in columns 4:C)."""
    cfg = field.cfg
    W, HW, C = cfg.netwidth, cfg.netwidth // 2, cfg.ins_num + 5
    XP, DP, CP = -(-cfg.pos_ch // 16) * 16, -(-cfg.view_ch // 16) * 16, -(-C // 16) * 16

    def wt(lin, rows=None):
        m = lin.weight.detach().T
        return torch.nn.functional.pad(m, (0, 0, 0, rows - m.shape[0])) if rows else m

    def cols(m, n, c0):
        out = torch.zeros(m.shape[0], n)
        out[:, c0:c0 + m.shape[1]] = m
        return out

    blocks = [wt(field.mlps[0], XP)]
    for i in range(1, cfg.netdepth):
        m = wt(field.mlps[i])
        blocks.append(m[:W])
        if i == cfg.skip + 1:
            blocks.append(torch.nn.functional.pad(m[W:], (0, 0, 0, XP - (m.shape[0] - W))))
    rh = wt(field.rgb_feature_linears[0])
    rh = torch.cat([rh[:W], torch.nn.functional.pad(rh[W:], (0, 0, 0, DP - (rh.shape[0] - W)))])
    return blocks + [wt(field.rgb_feature_linear), rh,
                     cols(wt(field.density_linear), 8, 3), wt(field.ins_feature_linear),
                     wt(field.ins_feature_linears[0]), cols(wt(field.rgb_linear), 8, 0),
                     cols(wt(field.ins_linear), CP, 4)]


@pytest.mark.parametrize("shape", [
    dict(netdepth=8, netwidth=256, multires=10, multires_views=4, ins_num=32),
    STRESS64, dict(netdepth=8, netwidth=64, multires=10, multires_views=4, ins_num=123)],
    ids=["flagship", "128-65", "64-123"])
def test_f32_composite_slabs_unpack_to_the_weights(shape):
    """pack_field's slabs for the f32 builds of K3, K4 and K5: read at the
    offsets the kernel's plan takes from slab_meta, the segments of K3's
    plan tile the buffer without a gap, each a run of 8-row slabs of 16 n
    words, hi then lo, in the [2, n/8, 8, 4] order of the no-swizzle
    K-major layout; hi is representable in TF32 (13 low bits clear), lo =
    w - hi, and hi + lo gives every weight of the field bit for bit. K4's
    and K5's plans read subsets of K3's, in its order. The bf16 build and
    a packing for K1/K2 alone carry no slabs."""
    _, _, field = _field(torch.float32, seed=8, **shape)
    packed = krf.pack_field(field)
    assert packed.slabs.dtype == torch.float32 and len(packed.slab_meta) == 36 + 24
    assert np.array_equal(packed.slab_meta[:36], packed.meta)
    plan = _composite_plan(packed.slab_meta, "all")
    blocks = _field_blocks(field)
    assert len(plan) == len(blocks) == len([o for o in packed.slab_meta[36:] if o >= 0])
    end = 0
    for (off, rows, n), want in zip(plan, blocks):
        assert off == end and rows % 8 == 0 and n % 8 == 0
        end = off + rows * n * 2
        x = packed.slabs[off:end].reshape(rows // 8, 2, 2, n // 8, 8, 4)
        hi, lo = (x[:, i].permute(0, 1, 4, 2, 3).reshape(rows, n) for i in (0, 1))
        assert not (hi.view(torch.int32) & 0x1FFF).any()
        assert torch.equal(lo, want - hi) and torch.equal(hi + lo, want)
        assert torch.equal(hi, krf.rna_tf32(want))
    assert end == packed.slabs.numel()
    for heads in ("sigma", "ins"):
        sub = _composite_plan(packed.slab_meta, heads)
        assert [plan.index(s) for s in sub] == sorted(plan.index(s) for s in sub)
    assert krf.pack_field(field, slabs=False).slabs is None
    assert torch.equal(krf.with_slabs(krf.pack_field(field, slabs=False)).slabs, packed.slabs)
    _, _, bf = _field(torch.bfloat16, seed=8, **shape)
    assert krf.pack_field(bf).slabs is None


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_cpu_wrappers_take_the_plain_version_without_launching(prec):
    cfg_j, params, field = _field({"bf16": torch.bfloat16, "f32": torch.float32}[prec])
    pts, vd, z, rd = _t(*_rays())
    krf.reset_launches()
    with torch.no_grad():
        for p in (field, krf.pack_field(field)):
            torch.testing.assert_close(krf.render_field_sigma(p, pts, z, rd),
                                       krf.render_field_sigma_ref(field, pts, z, rd))
            for a, b in zip(krf.render_field_all(p, pts, vd, z, rd),
                            krf.render_field_all_ref(field, pts, vd, z, rd)):
                torch.testing.assert_close(a, b)
            torch.testing.assert_close(krf.render_field_ins(p, pts, z, rd),
                                       krf.render_field_ins_ref(field, pts, z, rd))
    assert krf.LAUNCHES == {"render_field_sigma": 0, "render_field_all": 0,
                            "render_field_ins": 0, "render_field_sigma_f32": 0,
                            "render_field_all_f32": 0, "render_field_ins_f32": 0}


def test_wrapper_validation_rejects_what_the_kernel_does_not_take():
    _, _, f32_field = _field(torch.float32)
    _, _, field = _field(torch.bfloat16)
    packed = krf.pack_field(field)
    pts, vd, z, rd = _t(*_rays())
    krf._check(packed, pts, z, rd, vd)            # the accepted form
    f32_packed = krf.pack_field(f32_field)        # each precision has its build
    krf._check(f32_packed, pts, z, rd, vd)
    assert (krf.build_of(packed, "x"), krf.build_of(f32_packed, "x")) == ("", "_f32")
    with pytest.raises(TypeError, match="no kernel build for weights of torch.float16"):
        krf._check(packed._replace(w=packed.w.half()), pts, z, rd, vd)
    with pytest.raises(ValueError):
        krf._check(packed, pts[:, :4], z, rd)
    with pytest.raises(ValueError):
        krf._check(packed, pts.transpose(0, 1).contiguous().transpose(0, 1), z, rd)
    with pytest.raises(TypeError):
        krf._check(packed, pts.double(), z, rd)
    with pytest.raises(ValueError):
        krf._check(packed, pts, z, rd, vd[:, 0])
    with pytest.raises(ValueError):
        krf.render_field_sigma(packed, pts.to("meta"), z, rd)
    with pytest.raises(ValueError):
        krf.render_field_ins(packed, pts.to("meta"), z, rd)
    with pytest.raises(ValueError):
        krf.make_render_field(field.cfg, heads="rgb")
    # a field of one precision is refused by the render field built for the
    # other, and taken by its own
    with pytest.raises(ValueError):
        krf.make_render_field(f32_field.cfg, heads="sigma")(field, pts, z, rd)
    krf.make_render_field(f32_field.cfg, heads="sigma")(f32_packed, pts, z, rd)
    # K5 takes no view directions
    rf_ins = krf.make_render_field(field.cfg, heads="ins")
    with pytest.raises(TypeError):
        rf_ins(field, pts, vd, z, rd)
    with pytest.raises(ValueError):
        krf.make_render_field(f32_field.cfg, heads="ins")(field, pts, z, rd)
    krf.make_render_field(f32_field.cfg, heads="ins")(f32_packed, pts, z, rd)
    # the limits every field kernel shares (check_kernel_shape): the output
    # columns 4+ins_num+1 pad to at most 128 at any width, so ins_num 64 and
    # 123 are taken at width 256, 65 at 128 (replica64_stress) and 123 at 64,
    # and 124 is not; no layer wider than 256
    wide = dict(netdepth=2, netwidth=256, multires=10, multires_views=4)
    for width, ins_num in ((256, 64), (256, 123), (128, 65), (64, 123)):
        shape = tf.FieldConfig(**{**wide, "netwidth": width}, ins_num=ins_num)
        krf.check_kernel_shape(shape, "render_field")
        krf._check(krf.pack_field(tf.DMNeRFField(shape)), pts, z, rd, vd)
    for width in (256, 64):
        bad = krf.pack_field(tf.DMNeRFField(tf.FieldConfig(**{**wide, "netwidth": width},
                                                           ins_num=124)))
        with pytest.raises(ValueError, match=r"padded to 144 \(ins_num 124\) must be at "
                                             r"most 128"):
            krf._check(bad, pts, z, rd, vd)
    with pytest.raises(ValueError, match="netwidth 288 must be at most 256"):
        krf.check_kernel_shape(tf.FieldConfig(**{**wide, "netwidth": 288}, ins_num=4), "x")
    with pytest.raises(ValueError, match="netwidth 48 must be a multiple of 32"):
        krf.check_kernel_shape(tf.FieldConfig(**{**wide, "netwidth": 48}, ins_num=4), "x")
