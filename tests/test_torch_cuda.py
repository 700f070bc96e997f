"""The port's CUDA kernels on an NVIDIA card against their plain versions:
the render kernels K3/K4, the edit kernel K5 and the training kernels K1/K2
(up to ins_num 123 at width 256, 128 and 64), K3 and K5 against the composite of K1's
raw at shapes whose rays cross tiles and blocks, K4 at every grouping of
rays, the f32 builds of K1-K5 against the plain f32 path and the f32
render's and edit's launches, the edit path's launches of K1 and K5, the
mesh path's density query (K1) and vertex labels (K4 + K3), the stress
scenes' ground truth march
(data/procedural.py) on the card against the CPU, the JPEG codec
(native/jpeg.cpp, built by this machine's g++) on its golden fixtures,
LPIPS (eval/lpips.py) on the card against the CPU, a train step split
over two ranks on the one card (gloo) against one rank, and three train
steps at dmsr_k32's widths that wait for the card only to copy the LAP's
costs, bit for bit the steps of the formulations that wait more.

Imports no jax, so the machine with the card runs it without the JAX package's
conftest:  python -m pytest --noconftest tests/test_torch_cuda.py -q
Without a card it skips.
"""

import numpy as np
import pytest
import torch

from dmnerf_torch.kernels import field as kf
from dmnerf_torch.kernels import render_field as krf
from dmnerf_torch.models.fields import FieldConfig, init_field_params


F32_UNUSED = {"render_field_sigma_f32": 0, "render_field_all_f32": 0,
                 "render_field_ins_f32": 0}


def _rays(R, S, seed=3):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(R, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True) \
        * rng.uniform(0.8, 1.2, (R, 1)).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 6.0, (R, S)), -1).astype(np.float32)
    pts = ro[:, None, :] + rd[:, None, :] * z[:, :, None]
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True))[:, None, :]
    return [torch.from_numpy(np.array(x)).cuda() for x in (pts, vd, z, rd)]


@pytest.mark.cuda
@pytest.mark.parametrize("width,ins_num,S", [(64, 11, 100), (256, 32, 192), (64, 123, 100)])
def test_kernels_match_plain_versions_on_the_card(width, ins_num, S):
    """K4, K3 and K5 vs their plain versions on the same card: bf16 operands
    and fp32 accumulation both ways (TF32 off), so only the summation order
    differs, which can flip a stored bf16 activation by one ulp (2^-8
    relative). Bound: 2e-2 abs per ray on any output (weights and rgb in
    [0,1], depth up to 6, logits of a few units), median error 1e-4. The last
    sample's distance is 1e10, so its alpha is a step in sign(sigma): a ray
    whose plain last-sample |sigma| < 0.05 may jump, and is exempt (at most
    2 of 64). S=100 leaves a partial 128-point tile in the kernel; width 64
    with ins_num 123 has an output layer twice as wide as the trunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = FieldConfig(netdepth=8, netwidth=width, multires=10, multires_views=4,
                      ins_num=ins_num)
    field = init_field_params(torch.Generator().manual_seed(4), cfg, device="cuda")
    pts, vd, z, rd = _rays(64, S)
    krf.reset_launches()
    with torch.no_grad():
        pairs = [(krf.render_field_sigma(field, pts, z, rd),
                  krf.render_field_sigma_ref(field, pts, z, rd))]
        pairs += list(zip(krf.render_field_all(field, pts, vd, z, rd),
                          krf.render_field_all_ref(field, pts, vd, z, rd)))
        pairs.append((krf.render_field_ins(field, pts, z, rd),
                      krf.render_field_ins_ref(field, pts, z, rd)))
        step = field.density(pts[:, -1])[..., 0].abs() < 0.05
    torch.cuda.synchronize()
    assert krf.LAUNCHES == {"render_field_sigma": 1, "render_field_all": 1,
                            "render_field_ins": 1, **F32_UNUSED}
    for got, want in pairs:
        assert got.shape == want.shape and torch.isfinite(got).all()
        err = (got - want).abs()
        off = err.reshape(64, -1).amax(1) > 2e-2
        assert not (off & ~step).any() and off.sum() <= 2, (err.max(), off.sum())
        assert err.median() <= 1e-4, err.median()


@pytest.mark.cuda
@pytest.mark.parametrize("width,ins_num,R,S", [
    (256, 64, 64, 192), (256, 123, 64, 192), (256, 32, 37, 16), (256, 32, 13, 100),
    (256, 32, 9, 200), (256, 64, 5, 200), (256, 32, 1, 192), (256, 123, 1, 100),
    (128, 65, 64, 128), (64, 123, 13, 100)])
def test_render_kernels_on_k1s_core_at_any_grouping(width, ins_num, R, S):
    """K3 and K5 walk G whole rays per block in 128-point tiles, so a tile
    may hold the end of one ray and the start of the next, and the last
    block may hold fewer rays: S = 16, 100, 192 and 200, R prime, and R = 1.
    At width 256 up to ins_num 123 (CP 128, the widest output the kernels
    take); at replica64_stress's width 128 with ins_num 65 (CP 80, more than
    half the width); at width 64 with ins_num 123, where the fp32 raw that
    K3/K5 stage needs more room than their activation buffers. K4, K3 and K5 against their plain versions at
    test_kernels_match_plain_versions_on_the_card's bars; K5's logits equal
    K3's bit for bit (the rgb rows of the output layer add exact zeros to
    them); and K3 equals core/rendering.composite of K1's raw (K1 and K3 run
    the same tile forward, so the raw is the same to the last bit) up to the
    fp32 rounding of the scan and of torch's sums: 2e-5 of each output's
    largest magnitude (at least 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dmnerf_torch.core.rendering import composite
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = FieldConfig(netdepth=8, netwidth=width, multires=10, multires_views=4,
                      ins_num=ins_num)
    field = init_field_params(torch.Generator().manual_seed(6), cfg, device="cuda")
    packed = krf.pack_field(field)
    pts, vd, z, rd = _rays(R, S, seed=R + S)
    krf.reset_launches()
    with torch.no_grad():
        k3 = krf.render_field_all(packed, pts, vd, z, rd)
        k5 = krf.render_field_ins(packed, pts, z, rd)
        pairs = [(krf.render_field_sigma(packed, pts, z, rd),
                  krf.render_field_sigma_ref(field, pts, z, rd))]
        pairs += list(zip(k3, krf.render_field_all_ref(field, pts, vd, z, rd)))
        pairs.append((k5, krf.render_field_ins_ref(field, pts, z, rd)))
        comp = composite(kf.field_forward(packed, pts, vd), z, rd, keep_air=True)
        step = field.density(pts[:, -1])[..., 0].abs() < 0.05
    torch.cuda.synchronize()
    assert krf.LAUNCHES == {"render_field_sigma": 1, "render_field_all": 1,
                            "render_field_ins": 1, **F32_UNUSED}
    for got, want in pairs:
        assert got.shape == want.shape and torch.isfinite(got).all()
        off = (got - want).abs().reshape(R, -1).amax(1) > 2e-2
        assert not (off & ~step).any() and off.sum() <= max(2, R // 32), off.sum()
    assert torch.equal(k5, k3[2])
    for got, want in zip(k3, (comp.rgb, comp.depth, comp.ins_logits)):
        err = float((got - want).abs().max())
        assert err <= 2e-5 * max(1.0, float(want.abs().max())), err


# The f32 builds against the plain f32 path (TF32 off): activations and sums
# are fp32 on both sides, but the kernels' products are three TF32 passes
# on split operands (fp32-accurate: 8.9e-7 of the raw's scale and 1.6e-6
# relative L2 of the gradients in the CPU's emulation at the flagship width,
# tests/test_torch_f32_split.py), and the order of the sums differs. K2's
# forward recompute sums in order of k as the plain GEMM does, so the
# gradients see the plain path's ReLU masks.
F32_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("width,ins_num,R,S,pe", [
    (64, 11, 37, 100, (10, 4)), (128, 65, 16, 70, (10, 4)), (256, 32, 16, 70, (10, 4)),
    (64, 11, 37, 100, (7, 2)), (256, 32, 7, 45, (10, 4)), (32, 4, 7, 45, (4, 2))],
    ids=["64-11-37-100", "128-65-16-70", "256-32-16-70", "64-11-37-100-tail", "256-32-7-45",
         "32-4-7-45"])
def test_f32_kernels_match_plain_versions_on_the_card(width, ins_num, R, S, pe):
    """The f32 builds of K1-K5 vs their plain f32 versions: raw and every
    render output within 1e-4 of max(1, its largest magnitude); K2's
    gradients and encoding cotangents within 1e-4 relative L2, bit-identical
    across launches. The last sample's distance is 1e10, so its alpha is a
    step in sign(sigma): rays whose plain last-sample |sigma| < 1e-3 are
    exempt. A small field (width 64), replica64_stress's shape (width 128,
    ins_num 65), the flagship width and the narrowest (width 32, where each
    warpgroup of the f32 composites owns one 8-column tile of a layer); R*S
    is not a multiple of the f32 builds' 64-point tile, and rays cross
    tiles; at R = 7 the f32 composites launch fewer blocks than the card
    has SMs. PE 7/2 (XP 48, W + DP 80) leaves a 16-deep last slab behind
    the 32-deep slabs of K1's f32 build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = FieldConfig(netdepth=8, netwidth=width, multires=pe[0], multires_views=pe[1],
                      ins_num=ins_num, compute_dtype=torch.float32)
    field = init_field_params(torch.Generator().manual_seed(9), cfg, device="cuda")
    packed = krf.pack_field(field)
    assert packed.w.dtype == torch.float32
    pts, vd, z, rd = _rays(R, S)
    pf, dirs, ppd = kf.flatten_inputs(pts, vd)
    g = torch.randn(R * S, ins_num + 5, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1)) * 1e-3
    kf.reset_launches()
    krf.reset_launches()
    with torch.no_grad():
        pairs = [(krf.render_field_sigma(packed, pts, z, rd),
                  krf.render_field_sigma_ref(field, pts, z, rd))]
        pairs += list(zip(krf.render_field_all(packed, pts, vd, z, rd),
                          krf.render_field_all_ref(field, pts, vd, z, rd)))
        pairs.append((krf.render_field_ins(packed, pts, z, rd),
                      krf.render_field_ins_ref(field, pts, z, rd)))
        raw, want = kf.field_forward(packed, pts, vd), kf.field_forward_ref(field, pts, vd)
        step = field.density(pts[:, -1])[..., 0].abs() < 1e-3
    got = kf.field_backward(packed, pf, dirs, ppd, g, True, True)
    again = kf.field_backward(packed, pf, dirs, ppd, g, True, True)
    ref = kf.field_backward_ref(packed, pf, dirs, ppd, g, True, True)
    torch.cuda.synchronize()
    assert krf.LAUNCHES == {"render_field_sigma": 0, "render_field_all": 0,
                            "render_field_ins": 0, "render_field_sigma_f32": 1,
                            "render_field_all_f32": 1, "render_field_ins_f32": 1}
    assert kf.LAUNCHES == {"field_forward": 0, "field_backward": 0,
                           "field_forward_f32": 1, "field_backward_f32": 2}
    assert raw.shape == want.shape and torch.isfinite(raw).all()
    assert (raw - want).abs().max() <= F32_TOL * max(1.0, float(want.abs().max()))
    for a, b in pairs:
        assert a.shape == b.shape and torch.isfinite(a).all()
        err = (a - b).abs().reshape(R, -1).amax(1)[~step]
        assert err.max() <= F32_TOL * max(1.0, float(b.abs().max())), float(err.max())
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    pairs = list(zip(kf.unpack_grads(packed, got.dw, got.db),
                     kf.unpack_grads(packed, ref.dw, ref.db))) + [(got.gx, ref.gx),
                                                                  (got.gd, ref.gd)]
    for a, b in pairs:
        assert (a - b).norm() <= F32_TOL * b.norm(), float((a - b).norm() / b.norm())


def kernel_digests():
    """sha256 (16 hex digits) of what K1, K3, K4 and K5 (bf16 and f32) and
    K2's f32 build return for one field (8x256, ins_num 32, seed 5) and 16
    rays x 70 points (TF32 off)."""
    import hashlib
    torch.backends.cuda.matmul.allow_tf32 = False
    pts, vd, z, rd = _rays(16, 70, seed=5)
    pf, dirs, ppd = kf.flatten_inputs(pts, vd)
    g = torch.randn(16 * 70, 37, device="cuda", generator=torch.Generator("cuda").manual_seed(5))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = FieldConfig(netdepth=8, netwidth=256, multires=10, multires_views=4, ins_num=32,
                          compute_dtype=dtype)
        packed = krf.pack_field(init_field_params(torch.Generator().manual_seed(5), cfg,
                                                  device="cuda"))
        build = kf.build_of(packed, "digests")
        with torch.no_grad():
            got = {"K1": [kf.field_forward(packed, pts, vd)],
                   "K3": list(krf.render_field_all(packed, pts, vd, z, rd)),
                   "K4": [krf.render_field_sigma(packed, pts, z, rd)],
                   "K5": [krf.render_field_ins(packed, pts, z, rd)]}
        if dtype == torch.float32:
            got["K2"] = list(kf.field_backward(packed, pf, dirs, ppd, g, True, True))
        for name, tensors in got.items():
            h = hashlib.sha256()
            for t in tensors:
                h.update(t.detach().float().cpu().numpy().tobytes())
            out[name + build] = h.hexdigest()[:16]
    return out


# kernel_digests() of the build before K2's bf16 pipeline of its own
# (field_bwd_wgmma.cuh), on an NVIDIA H100 80GB HBM3 with CUDA 12.9's nvcc:
# that change leaves these kernels bit for bit as they were
PARENT_DIGESTS = {"K1": "6ed2b9ffb50cf7b5", "K3": "88a553a2495b3506", "K4": "4273883d49dfa336",
                  "K5": "fc1a4d011189545e", "K1_f32": "601f831237d1609e",
                  "K3_f32": "c09b8a191398166b", "K4_f32": "82ca0460bc65e2f2",
                  "K5_f32": "b38149c0985f0b4b", "K2_f32": "e7a6dc568a04c1ff"}


@pytest.mark.cuda
def test_other_kernels_equal_their_builds_before_the_k2_pipeline():
    """K1, K3, K4 and K5 (bf16 and f32) and the f32 K2 return the same bits as
    the build before K2's bf16 pipeline of its own, which shares no device
    code with them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    assert kernel_digests() == PARENT_DIGESTS


@pytest.mark.cuda
@pytest.mark.parametrize("width,ins_num,R,S", [(64, 11, 37, 100), (256, 32, 16, 70),
                                               (256, 32, 2, 50), (256, 64, 16, 70),
                                               (256, 123, 16, 70), (128, 65, 16, 70),
                                               (64, 123, 37, 100)])
def test_field_kernels_match_plain_versions_on_the_card(width, ins_num, R, S):
    """K1 vs DMNeRFField.forward and K2 vs field_backward_ref on the same
    card (TF32 off). Both round to bf16 at the same places; the order of fp32
    sums differs and can flip an activation by one bf16 ulp, which later
    layers (and ReLU masks) carry. Each raw column is held on its own, so the
    small rgb columns are not judged by the largest logits: its max error
    within 3% of its max |raw| and its relative L2 error within 5e-3
    (chip_smoke.py's bars; measured on an H100 at these shapes: 1.1e-2 and
    2.3e-3 at width 256, an rgb bias off by 10% 5.6e-3). Every
    parameter's gradient and the encoding cotangents within 3e-2 relative L2
    (the plain version moves by 1.1e-2 with f64 in place of f32 accumulation
    at width 256). K2 is bit-identical across launches, and an
    instance-logit loss gives the trunk exactly zero. R*S is not a multiple
    of the kernels' 128-point tile, and 100 points leave one partial tile.
    At width 256 ins_num 64 and 123 (CP 80 and 128) widen the cotangent K2's
    tile pass keeps beside the rgb branch; width 128 with ins_num 65 is
    replica64_stress's shape, and
    width 64 with ins_num 123 an output layer twice as wide as the trunk.
    Widths 128 and 256 run K2 on field_bwd_wgmma.cuh's pipeline, width 64 on
    field_core.cuh's mma.sync core (kernels/field.py::k2_core, counted in
    K2_CORES)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = FieldConfig(netdepth=8, netwidth=width, multires=10, multires_views=4,
                      ins_num=ins_num)
    field = init_field_params(torch.Generator().manual_seed(4), cfg, device="cuda")
    packed = krf.pack_field(field)
    pts, vd, _, _ = _rays(R, S)
    pf, dirs, ppd = kf.flatten_inputs(pts, vd)
    g = torch.randn(R * S, ins_num + 5, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0)) * 1e-3
    kf.reset_launches()
    with torch.no_grad():
        raw, want = kf.field_forward(packed, pts, vd), kf.field_forward_ref(field, pts, vd)
    got = kf.field_backward(packed, pf, dirs, ppd, g, True, True)
    again = kf.field_backward(packed, pf, dirs, ppd, g, True, True)
    ref = kf.field_backward_ref(packed, pf, dirs, ppd, g, True, True)
    g_ins = g.clone()
    g_ins[:, :4] = 0.0
    zero = kf.unpack_grads(packed, *kf.field_backward(packed, pf, dirs, ppd, g_ins)[:2])
    torch.cuda.synchronize()
    assert kf.LAUNCHES == {"field_forward": 1, "field_backward": 3, "field_forward_f32": 0,
                           "field_backward_f32": 0}
    core = "wgmma" if width in (128, 256) else "mma_sync"
    assert kf.k2_core(kf.layout(packed), packed.w.dtype) == core
    assert kf.K2_CORES == {"wgmma": 0, "mma_sync": 0, core: 3}
    assert raw.shape == want.shape and torch.isfinite(raw).all()
    raw, want = raw.reshape(-1, ins_num + 5), want.reshape(-1, ins_num + 5)
    err = (raw - want).abs()
    assert (err.amax(0) <= 3e-2 * want.abs().amax(0)).all()
    assert ((raw - want).norm(dim=0) <= 5e-3 * want.norm(dim=0)).all()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    pairs = list(zip(kf.unpack_grads(packed, got.dw, got.db),
                     kf.unpack_grads(packed, ref.dw, ref.db))) + [(got.gx, ref.gx),
                                                                  (got.gd, ref.gd)]
    for a, b in pairs:
        assert (a - b).norm() <= 3e-2 * b.norm(), float((a - b).norm() / b.norm())
    names = [n for n, _ in field.named_parameters()]
    assert all(not t.any() for n, t in zip(names, zero) if n.startswith("mlps."))
    assert zero[names.index("ins_linear.weight")].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("width,ins_num,R,S", [(256, 32, 16, 70), (256, 64, 16, 70),
                                               (256, 123, 2, 50), (128, 65, 16, 70)])
def test_k2_pipeline_gives_the_bits_of_the_mma_sync_core(width, ins_num, R, S, monkeypatch):
    """The bf16 K2 on field_bwd_wgmma.cuh's pipeline takes the mma.sync core's
    sums in its order (16-deep products in order of the reduction; the dW
    GEMM's points in order within each split, the bias sums point by point)
    and rounds where it does, so the two cores give the same gradients and
    encoding cotangents on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = FieldConfig(netdepth=8, netwidth=width, multires=10, multires_views=4,
                      ins_num=ins_num)
    packed = krf.pack_field(init_field_params(torch.Generator().manual_seed(6), cfg,
                                              device="cuda"))
    pts, vd, _, _ = _rays(R, S, seed=6)
    pf, dirs, ppd = kf.flatten_inputs(pts, vd)
    g = torch.randn(R * S, ins_num + 5, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6)) * 1e-3
    kf.reset_launches()
    got = kf.field_backward(packed, pf, dirs, ppd, g, True, True)
    monkeypatch.setattr(kf, "k2_core", lambda L, dtype: "mma_sync")
    was = kf.field_backward(packed, pf, dirs, ppd, g, True, True)
    torch.cuda.synchronize()
    assert kf.K2_CORES == {"wgmma": 1, "mma_sync": 1}
    for a, b in zip(got, was):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_train_steps_run_through_the_kernels():
    """Three train steps on the card: finite metrics, K1 and K2 twice per
    step (coarse and fine), and the same seed giving bit-identical weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dmnerf_torch.train.step import create_train_state, make_train_scan_step, scene_arrays
    from dmnerf_torch.config import default_config
    from dmnerf_torch.data.synthetic import make_scene

    scene = make_scene(H=16, W=16, n_train=2, n_test=1)
    args = default_config(N_train=256, N_samples=16, N_importance=16, near=1.0, far=12.0,
                          penalize=True, tolerance=0.05, deta_w=0.05, netdepth=8,
                          netwidth=64, multires=10, multires_views=4)
    args.ins_num = scene.ins_num
    cfg = FieldConfig.from_args(args)
    arrs = scene_arrays(scene, "cuda")
    runs = []
    for _ in range(2):
        kf.reset_launches()
        state = create_train_state(0, cfg, device="cuda")
        m = make_train_scan_step(args, cfg)(state, arrs, 1, scene.i_train, 3)
        torch.cuda.synchronize()
        assert all(torch.isfinite(v) for v in m.values())
        assert kf.LAUNCHES == {"field_forward": 6, "field_backward": 6,
                               "field_forward_f32": 0, "field_backward_f32": 0}
        runs.append([p.detach().clone() for p in state.opt.param_groups[0]["params"]])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_edit_launches_k1_and_k5_per_chunk():
    """A 2-object edit (rigid + deform) of a 12x12 image in chunks of 64 rays
    (3 chunks, the last one padded) through the kernels: per chunk
    2 * (1 + n_obj) launches of K1 and 1 + n_obj of K5, and none of K3 or
    K4; finite rgb and labels in [0, K]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dmnerf_torch.edit.manipulator import make_pose_image_manipulator
    from dmnerf_torch.config import default_config
    from dmnerf_torch.data.synthetic import make_scene

    scene = make_scene(H=12, W=12, n_train=1, n_test=1)
    args = default_config(N_test=64, N_samples=16, N_importance=32, near=1.0, far=12.0)
    cfg = FieldConfig(netdepth=8, netwidth=64, multires=10, multires_views=4,
                      ins_num=scene.ins_num)
    g = torch.Generator().manual_seed(5)
    params = {k: init_field_params(g, cfg, device="cuda") for k in ("coarse", "fine")}
    objs = [{"mode": "rigid"}, {"mode": "deform", "deform_func": "sin"}]
    run = make_pose_image_manipulator(cfg, params, args, objs, [1, 2], 12, 12, scene.K,
                                      device="cuda", use_pallas=True)
    ori = np.asarray(scene.poses[0], np.float64)
    trans = np.eye(4)
    trans[:3, 3] = [0.3, 0.0, 0.0]
    kf.reset_launches()
    krf.reset_launches()
    rgb, label, _, conf = run(ori, np.stack([trans @ ori, ori]), np.array([0.0, 0.5]))
    torch.cuda.synchronize()
    assert kf.LAUNCHES["field_forward"] == 3 * 2 * 3
    assert krf.LAUNCHES == {"render_field_sigma": 0, "render_field_all": 0,
                            "render_field_ins": 3 * 3, **F32_UNUSED}
    assert rgb.shape == (192, 3) and torch.isfinite(rgb).all() and torch.isfinite(conf).all()
    assert int(label.min()) >= 0 and int(label.max()) <= scene.ins_num


@pytest.mark.cuda
def test_f32_render_and_edit_launch_counts():
    """An f32 render of a 12x12 image in chunks of 64 rays (3 chunks) and a
    2-object f32 edit of it through the kernels launch the f32 builds alone,
    as many as the bf16 runs launch bf16 ones: per chunk one K4 and one K3
    for the render; 2 * (1 + n_obj) K1 and 1 + n_obj K5 for the edit; finite
    outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dmnerf_torch.config import default_config
    from dmnerf_torch.data.synthetic import make_scene
    from dmnerf_torch.edit.manipulator import make_pose_image_manipulator
    from dmnerf_torch.eval.renderer import make_image_renderer

    torch.backends.cuda.matmul.allow_tf32 = False
    scene = make_scene(H=12, W=12, n_train=1, n_test=1)
    args = default_config(N_test=64, N_samples=16, N_importance=32, near=1.0, far=12.0)
    cfg = FieldConfig(netdepth=8, netwidth=64, multires=10, multires_views=4,
                      ins_num=scene.ins_num, compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(7)
    params = {k: init_field_params(g, cfg, device="cuda").eval() for k in ("coarse", "fine")}
    ori = np.asarray(scene.poses[0], np.float32)
    kf.reset_launches()
    krf.reset_launches()
    out = make_image_renderer(cfg, args, 12, 12, device="cuda", use_pallas=True)(
        params, scene.K, ori)
    torch.cuda.synchronize()
    assert all(np.isfinite(o).all() for o in out)
    assert {k: v for k, v in {**kf.LAUNCHES, **krf.LAUNCHES}.items() if v} == {
        "render_field_sigma_f32": 3, "render_field_all_f32": 3}
    objs = [{"mode": "rigid"}, {"mode": "deform", "deform_func": "sin"}]
    run = make_pose_image_manipulator(cfg, params, args, objs, [1, 2], 12, 12, scene.K,
                                      device="cuda", use_pallas=True)
    trans = np.eye(4)
    trans[:3, 3] = [0.3, 0.0, 0.0]
    kf.reset_launches()
    krf.reset_launches()
    rgb, label, _, conf = run(ori.astype(np.float64), np.stack([trans @ ori, ori]),
                              np.array([0.0, 0.5]))
    torch.cuda.synchronize()
    assert {k: v for k, v in {**kf.LAUNCHES, **krf.LAUNCHES}.items() if v} == {
        "field_forward_f32": 3 * 2 * 3, "render_field_ins_f32": 3 * 3}
    assert torch.isfinite(rgb).all() and torch.isfinite(conf).all()


def _flagship_pair(seed, ins_num=4):
    cfg = FieldConfig(netdepth=8, netwidth=256, multires=10, multires_views=4,
                      ins_num=ins_num)
    g = torch.Generator().manual_seed(seed)
    return cfg, {k: init_field_params(g, cfg, device="cuda").eval() for k in ("coarse", "fine")}


@pytest.mark.cuda
def test_mesh_density_query_through_k1():
    """The mesh path's density query at the flagship width on a 64^3 grid
    (extents 8) through K1, 2^16 points per launch, against
    DMNeRFField.forward on the card: the sigma column's max error within 3%
    of its max |sigma| and its relative L2 error within 5e-3 (chip_smoke.py's
    RAW_COL_TOL and RAW_L2_TOL for K1's raw)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dmnerf_torch.mesh.extract import make_density_fn
    from dmnerf_torch.mesh.grid import grid_within_bound
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _flagship_pair(7)
    grid, _ = grid_within_bound([-1.0, 1.0], np.full(3, 8.0), np.eye(4), 64)
    grid = grid.astype(np.float32)
    kf.reset_launches()
    got = make_density_fn(cfg, 1 << 16, device="cuda", use_pallas=True)(params["fine"], grid)
    assert kf.LAUNCHES["field_forward"] == 64 ** 3 // (1 << 16)
    want = make_density_fn(cfg, 1 << 16, device="cuda", use_pallas=False)(params["fine"], grid)
    assert kf.LAUNCHES["field_forward"] == 64 ** 3 // (1 << 16)
    assert got.shape == want.shape == (64 ** 3,) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
    assert np.linalg.norm(got - want) <= 5e-3 * np.linalg.norm(want)


@pytest.mark.cuda
def test_mesh_labels_through_k4_and_k3():
    """The vertex labels through K4 + K3 (the fused route) against the plain
    unfused route on the same card and rays: the rays of the vertices of the
    sigma = 0.5 isosurface of a random flagship field on a 32^3 grid (its
    occupancy at the real voxel stays below the iso level), 256 rays per
    chunk. Labels agree on at least 98% of the rays (chip_smoke.py phase
    4b's bar for a render's labels); ceil(V / 256) launches of K4 and of K3,
    none of K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dmnerf_torch.config import default_config
    from dmnerf_torch.mesh.extract import make_density_fn, make_label_fn, vertex_rays
    from dmnerf_torch.mesh.grid import grid_within_bound
    from dmnerf_torch.mesh.marching import marching_cubes
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _flagship_pair(0)
    grid, _ = grid_within_bound([-1.0, 1.0], np.full(3, 8.0), np.eye(4), 32)
    sigma = make_density_fn(cfg, 1 << 16, device="cuda", use_pallas=False)(
        params["fine"], grid.astype(np.float32))
    verts, faces, _ = marching_cubes(sigma.reshape(32, 32, 32), 0.5)
    assert len(faces) > 100
    ro, rd = vertex_rays((verts / 31 - 0.5) * 8.0, faces, 1.0)
    args = default_config(N_samples=64, N_importance=128, near=1.0, far=12.0)
    kf.reset_launches()
    krf.reset_launches()
    got = make_label_fn(cfg, args, 256, device="cuda", use_pallas=True)(params, ro, rd)
    torch.cuda.synchronize()
    n = -(-len(ro) // 256)
    assert kf.LAUNCHES["field_forward"] == 0
    assert krf.LAUNCHES == {"render_field_sigma": n, "render_field_all": n,
                            "render_field_ins": 0, **F32_UNUSED}
    want = make_label_fn(cfg, args, 256, device="cuda", use_pallas=False)(params, ro, rd)
    assert got.dtype == np.int32 and got.shape == (len(ro),)
    assert int(got.min()) >= 0 and int(got.max()) < cfg.ins_num
    assert (got == want).mean() >= 0.98, (got == want).mean()


@pytest.mark.cuda
@pytest.mark.parametrize("edited", [False, True])
def test_stress_scene_ground_truth_on_the_card_equals_the_cpu(edited):
    """data/procedural.py::render_gt of the DM-SR stress scene (16 objects;
    edited: object 5 translated as the mani split moves it) at 48x64 and 192
    samples on the card against the same march on the CPU: the ray
    directions come from the host on both, so only exp and the sums' order
    differ; images within 1e-5 everywhere, labels (argmax of the weights)
    equal on at least 99.9% of the pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dmnerf_torch.data.procedural import edited_objects, make_objects, render_gt
    from dmnerf_torch.edit.transforms import _center_conjugate, _mode_matrix, pose_spherical
    objs = make_objects(16, seed=0)
    if edited:
        T = _center_conjugate(_mode_matrix("translation"), objs[4].center.tolist())
        objs = edited_objects(objs, 5, T)
    H, W = 48, 64
    focal = 0.5 * W / np.tan(0.6)
    K = np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1.0]])
    for theta in (0.0, 90.0, 200.0):
        pose = pose_spherical(theta, -35.0, 4.3)
        img_c, lab_c = render_gt(pose, H, W, K, 1.0, 14.0, objs, device="cpu")
        img_g, lab_g = render_gt(pose, H, W, K, 1.0, 14.0, objs, device="cuda")
        assert img_g.dtype == np.float32 and lab_g.dtype == np.int32
        assert np.abs(img_g - img_c).max() <= 1e-5
        assert (lab_g == lab_c).mean() >= 0.999


@pytest.mark.cuda
def test_jpeg_codec_on_the_golden_fixtures():
    """The codec that the card machine's g++ builds decodes every fixture of
    tests/torch_golden/jpeg to the array Pillow decoded and encodes every
    imageio-default source to its bytes (jpeg_fixtures.jpeg_golden, as
    chip_smoke.py phase 15(a) does), and reads a 968x1296 frame that goes
    to the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card machine: its toolchain builds the codec")
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden",
                                    "jpeg"))
    import jpeg_fixtures
    from dmnerf_torch.utils.jpeg import encode_jpeg, read_jpeg

    n_dec, n_enc = jpeg_fixtures.jpeg_golden()
    assert n_dec >= 10 and n_enc == 3
    frame = jpeg_fixtures.smooth_frame(968, 1296)
    img = torch.from_numpy(read_jpeg(encode_jpeg(frame))).cuda()
    assert img.shape == (968, 1296, 3) and img.dtype == torch.uint8
    assert (img.float() - torch.from_numpy(frame).cuda().float()).abs().mean() < 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [False, True])
def test_lpips_on_the_card_equals_the_cpu(normalize):
    """eval/lpips.py on a 480x640 pair (640x480 frames) on the card against
    the CPU, random weights in the .npz layout: cuDNN runs the convolutions
    with TF32 off (lpips_distance turns it off around them, even when the
    global flag is on), so the two agree within 1e-4 of max(1, |CPU|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dmnerf_torch.eval.lpips import lpips_distance, prepare_params, random_weights
    w = random_weights(0)
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    cpu = float(lpips_distance(prepare_params(w, "cpu"), torch.from_numpy(a),
                               torch.from_numpy(b), normalize=normalize))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = float(lpips_distance(prepare_params(w, "cuda"), torch.from_numpy(a).cuda(),
                                    torch.from_numpy(b).cuda(), normalize=normalize))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert cpu > 0 and abs(card - cpu) <= 1e-4 * max(1.0, abs(cpu))


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_one_rank(tmp_path):
    """One train step at width 64 (K1 and K2 on 128 of the 256 rays per
    rank) over two ranks on cuda:0, their collectives over gloo, against
    one rank: each rank launched K1 and K2 twice, both hold the same
    parameters bit for bit, the losses agree within 1e-5 relative (the
    order of f32 sums over the ranks) and the gradients within 3e-2
    relative L2 (chip_smoke's GRAD_TOL: K2 rounds its incoming gradient to
    bf16, and a last-bit change of it cascades)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import torch_parallel_ranks as ranks

    got = ranks.run_ranks("card_step", 2, tmp_path, {}, "cuda:0", "gloo")
    want = ranks.card_step(None, {})
    for r in got:
        assert r["launches"] == {"field_forward": 2, "field_backward": 2,
                                 "field_forward_f32": 0, "field_backward_f32": 0}
        assert all(torch.equal(a, b) for a, b in zip(r["params"], got[0]["params"]))
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got[0]["metrics"][k], v, rtol=1e-5, err_msg=k)
    for g, w in zip(got[0]["grads"], want["grads"]):
        assert float((g - w).norm() / w.norm().clamp_min(1e-30)) <= 3e-2


@pytest.mark.cuda
def test_train_step_waits_for_the_card_only_to_copy_the_costs(monkeypatch):
    """Three train steps at dmsr_k32's widths (two 8x256 fields, PE 10/4,
    64 + 128 samples, 3072 rays, 32 slots, penalizer, bf16) on K1/K2. Under
    torch.cuda.set_sync_debug_mode("error") inside every `train.step` span,
    with only `lap.copy_to_host` exempt, no call synchronizes; and each
    step's losses, gradients and weights are bit for bit those of the
    formulations that wait (tests/syncing_forms.py: torch.cumprod's
    autograd, torch.bincount and the assignments' copy back from pageable
    memory), which do raise under the same mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import contextlib

    import syncing_forms
    from dmnerf_torch.config import default_config
    from dmnerf_torch.core import rendering
    from dmnerf_torch.data.synthetic import make_scene
    from dmnerf_torch.losses import instance
    from dmnerf_torch.train import step as train_step
    from dmnerf_torch.train.step import create_train_state, make_train_scan_step, scene_arrays

    torch.backends.cuda.matmul.allow_tf32 = False
    scene = make_scene(H=64, W=64, n_train=3, n_test=1)
    args = default_config(N_train=3072, N_samples=64, N_importance=128, near=1.0, far=12.0,
                          penalize=True, tolerance=0.05, deta_w=0.05, netdepth=8,
                          netwidth=256, multires=10, multires_views=4, skip=4)
    args.ins_num = 32
    cfg = FieldConfig.from_args(args)
    arrs = scene_arrays(scene, "cuda")
    # 32 slots: labels drawn over all of them, ~31 present in a batch
    labels = torch.randint(0, 32, arrs.labels.shape, generator=torch.Generator().manual_seed(2))
    arrs = arrs._replace(labels=labels.cuda())

    def steps():
        state = create_train_state(0, cfg, device="cuda")
        scan = make_train_scan_step(args, cfg)
        out = []
        for _ in range(3):
            m = scan(state, arrs, 11, scene.i_train, 1)
            params = state.opt.param_groups[0]["params"]
            out.append((m, [p.grad.clone() for p in params], [p.detach().clone() for p in params]))
        torch.cuda.synchronize()
        return out

    real = train_step.span

    @contextlib.contextmanager
    def span(name):
        """The program's span; synchronizing raises inside every step, and
        not inside the costs' copy."""
        modes = {"train.step": ("error", 0), "lap.copy_to_host": (0, "error")}.get(name)
        with real(name):
            if modes:
                torch.cuda.set_sync_debug_mode(modes[0])
            try:
                yield
            finally:
                if modes:
                    torch.cuda.set_sync_debug_mode(modes[1])

    with monkeypatch.context() as mp:
        mp.setattr(train_step, "span", span)
        mp.setattr(instance, "span", span)
        got = steps()
    assert torch.cuda.get_sync_debug_mode() == 0

    with monkeypatch.context() as mp:
        mp.setattr(rendering, "alpha_weights", syncing_forms.cumprod_alpha_weights)
        mp.setattr(instance, "build_gt_onehot", syncing_forms.bincount_gt_onehot)
        mp.setattr(instance, "ins_loss_from_stats", syncing_forms.pageable_ins_loss_from_stats)
        want = steps()
        mp.setattr(train_step, "span", span)
        with pytest.raises(RuntimeError, match="synchroniz"):
            steps()
    torch.cuda.set_sync_debug_mode(0)

    for (gm, gg, gp), (wm, wg, wp) in zip(got, want):
        assert gm.keys() == wm.keys()
        assert all(torch.equal(gm[k], wm[k]) for k in gm)
        assert all(torch.equal(a, b) for a, b in zip(gg, wg))
        assert all(torch.equal(a, b) for a, b in zip(gp, wp))
