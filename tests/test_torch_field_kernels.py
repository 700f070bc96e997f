"""dmnerf_torch/kernels/field (K1/K2) on the CPU: FusedField's forward and
gradients (the plain versions: DMNeRFField.forward and field_backward_ref)
vs the JAX package's trainable Pallas field in interpret mode and vs
jax.grad of apply_field; field_backward_ref vs torch.autograd of
DMNeRFField; the instance-branch detachment; the gradient unpacking; the
unfused eval path on K1; and the wrappers' dispatch and validation. The
kernels themselves run on a card only: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmnerf_tpu.config import default_config
from dmnerf_tpu.data.synthetic import make_scene
from dmnerf_tpu.eval.renderer import make_image_renderer as jax_image_renderer
from dmnerf_tpu.models import fields as jf
from dmnerf_tpu.ops.pallas.field_kernels import make_trainable_pallas_field as jax_ptf
from dmnerf_torch.eval.renderer import make_image_renderer
from dmnerf_torch.kernels import field as kf
from dmnerf_torch.kernels.render_field import pack_field
from dmnerf_torch.models import fields as tf
from dmnerf_torch.models.convert import state_dict_from_jax

# tests/test_pallas_train.py's field
CFG = dict(netdepth=3, netwidth=32, multires=3, multires_views=2, ins_num=3, skip=1)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(prec, seed=0, **over):
    dj, dt = DTYPES[prec]
    kw = {**CFG, **over}
    cfg_j = jf.FieldConfig(**kw, compute_dtype=dj)
    params = jf.init_field_params(jax.random.PRNGKey(seed), cfg_j)
    field = tf.DMNeRFField(tf.FieldConfig(**kw, compute_dtype=dt))
    field.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return cfg_j, params, field


def _inputs(R=4, S=5, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, 1, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts, dirs


def _loss_weights(C):
    return np.arange(C, dtype=np.float32)


def _torch_grads(field, pts, dirs, trainable=True):
    p = torch.from_numpy(pts).requires_grad_(True)
    d = torch.from_numpy(dirs).requires_grad_(True)
    field.zero_grad(set_to_none=True)
    fn = kf.make_trainable_pallas_field(field.cfg) if trainable else (lambda m, a, b: m(a, b))
    raw = fn(field, p, d)
    (torch.sin(raw) * torch.from_numpy(_loss_weights(raw.shape[-1]))).sum().backward()
    return (raw.detach().numpy(), {n: q.grad.numpy() for n, q in field.named_parameters()},
            p.grad.numpy(), d.grad.numpy())


def _jax_grads(field_fn, params, pts, dirs):
    def loss(p, q, d):
        raw = field_fn(p, q, d)
        return jnp.sum(jnp.sin(raw) * _loss_weights(raw.shape[-1]))

    raw = np.asarray(field_fn(params, jnp.asarray(pts), jnp.asarray(dirs)), np.float32)
    gp, gq, gd = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(pts), jnp.asarray(dirs))
    sd = state_dict_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), gp))
    return raw, {k: v.numpy() for k, v in sd.items()}, np.asarray(gq), np.asarray(gd)


# f32: the JAX bars of tests/test_pallas_train.py (5e-3); only the order of
# f32 sums differs. bf16: the same rounding places on both sides, but a
# different f32 summation order (and the Pallas kernel's grouped encoding)
# can flip one bf16 ulp of an activation or of an activation gradient
# (2^-8 relative), which later layers carry; 3e-2 relative to each
# gradient's largest entry.
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_fused_field_matches_jax_pallas_and_apply_field(prec):
    cfg_j, params, field = _pair(prec)
    pts, dirs = _inputs()
    got = _torch_grads(field, pts, dirs)
    pallas = jax_ptf(cfg_j)
    for want in (_jax_grads(pallas, params, pts, dirs),
                 _jax_grads(lambda p, q, d: jf.apply_field(p, cfg_j, q, d), params, pts, dirs)):
        if prec == "f32":
            np.testing.assert_allclose(got[0], want[0], atol=2e-3, rtol=1e-3)
            for name in got[1]:
                np.testing.assert_allclose(got[1][name], want[1][name], atol=5e-3, rtol=5e-3,
                                           err_msg=name)
            np.testing.assert_allclose(got[2], want[2], atol=5e-3, rtol=5e-3)
            np.testing.assert_allclose(got[3], want[3], atol=5e-3, rtol=5e-3)
        else:
            np.testing.assert_allclose(got[0], want[0], atol=3e-2, rtol=0)
            for name in got[1]:
                scale = np.abs(want[1][name]).max()
                assert np.abs(got[1][name] - want[1][name]).max() <= 3e-2 * scale, name
            for g, w in zip(got[2:], want[2:]):
                assert np.abs(g - w).max() <= 3e-2 * np.abs(w).max()


@pytest.mark.parametrize("prec,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_backward_ref_matches_torch_autograd(prec, tol):
    """field_backward_ref (through FusedField) vs autograd of DMNeRFField.
    f32: the same math, f32 summation order only (1e-5 relative L2). bf16:
    autograd rounds the cotangents wherever the forward casts (it flows bf16
    gradients through each cast), not where _bwd_kernel rounds: 2e-2
    relative L2 per parameter."""
    _, _, field = _pair(prec, seed=1, netdepth=4, skip=1, ins_num=4)
    pts, dirs = _inputs(R=6, S=7, seed=1)
    got = _torch_grads(field, pts, dirs)
    want = _torch_grads(field, pts, dirs, trainable=False)
    np.testing.assert_array_equal(got[0], want[0])          # both are DMNeRFField.forward
    for name in got[1]:
        err = np.linalg.norm(got[1][name] - want[1][name]) / np.linalg.norm(want[1][name])
        assert err <= tol, (name, err)
    for g, w in zip(got[2:], want[2:]):
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= tol


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_instance_branch_passes_nothing_to_the_trunk(prec):
    """A loss on the instance logits alone: the trunk's gradients are exactly
    zero (reference dm_nerf.py:95), the instance head's are not."""
    _, _, field = _pair(prec)
    pts, dirs = _inputs()
    raw = kf.make_trainable_pallas_field(field.cfg)(field, torch.from_numpy(pts),
                                                    torch.from_numpy(dirs))
    raw[..., 4:].square().sum().backward()
    for name, p in field.named_parameters():
        if name.startswith("mlps.") or name.startswith("density") or name.startswith("rgb"):
            assert not p.grad.any(), name
    assert field.ins_linear.weight.grad.abs().sum() > 0
    assert field.ins_feature_linear.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("over", [{}, {"netdepth": 5, "skip": 2, "ins_num": 11}])
def test_unpack_grads_is_the_transpose_of_pack_field(over):
    """unpack_grads on the packed weights themselves gives back every
    parameter exactly (f32 packing: no rounding), so each gradient lands on
    the parameter whose weight sits at that packed position."""
    _, _, field = _pair("f32", seed=2, **over)
    packed = pack_field(field)
    back = kf.unpack_grads(packed, packed.w, packed.b)
    for (name, p), q in zip(field.named_parameters(), back):
        assert q.shape == p.shape and torch.equal(q, p.detach()), name


def test_unfused_pallas_renderer_matches_jax():
    """make_image_renderer(use_pallas=True, fused=False): render_rays with
    the field through K1's wrapper, vs the JAX package's unfused Pallas path
    (make_pallas_field, interpret mode), f32. An importance sample can cross
    a bin where the cdf's cumsum runs in another order: the bounds of
    tests/test_torch_renderer.py (5e-3 rgb/conf, 5e-2 depth, equal labels)."""
    scene = make_scene(H=8, W=8, n_train=1, n_test=2)
    args = default_config(N_test=32, N_samples=8, N_importance=8, near=1.0, far=12.0,
                          precision="f32", netdepth=6, netwidth=32, multires=4,
                          multires_views=2)
    args.ins_num = scene.ins_num
    cfg_j = jf.FieldConfig.from_args(args)
    pj = {k: jf.init_field_params(jax.random.PRNGKey(s), cfg_j)
          for k, s in (("coarse", 0), ("fine", 1))}
    pt = {}
    for k, v in pj.items():
        pt[k] = tf.DMNeRFField(tf.FieldConfig.from_args(args))
        pt[k].load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, v)))
    got_r = make_image_renderer(pt["coarse"].cfg, args, 8, 8, device="cpu", use_pallas=True,
                                fused=False)
    want_r = jax_image_renderer(cfg_j, args, 8, 8, use_pallas=True, fused=False)
    for pose in scene.poses[scene.i_test]:
        got, want = got_r(pt, scene.K, pose), want_r(pj, scene.K, pose)
        for g, w, tol in zip(got, want, (5e-3, 0, 5e-3, 5e-2)):
            np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=0)


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_cpu_wrappers_take_the_plain_version_without_launching(prec):
    _, _, field = _pair(prec)
    pts, dirs = (torch.from_numpy(x) for x in _inputs())
    packed = pack_field(field)
    kf.reset_launches()
    with torch.no_grad():
        for p in (field, packed):
            torch.testing.assert_close(kf.field_forward(p, pts, dirs),
                                       kf.field_forward_ref(field, pts, dirs), rtol=0, atol=0)
    pf, d, ppd = kf.flatten_inputs(pts, dirs)
    g = torch.randn(pf.shape[0], field.cfg.ins_num + 5)
    a = kf.field_backward(packed, pf, d, ppd, g, True, True)
    b = kf.field_backward_ref(packed, pf, d, ppd, g, True, True)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert kf.LAUNCHES == {"field_forward": 0, "field_backward": 0,
                           "field_forward_f32": 0, "field_backward_f32": 0}
    assert kf.K2_CORES == {"wgmma": 0, "mma_sync": 0}


# (netdepth, netwidth, ins_num, compute dtype) -> the core of K2's bf16 build
# (kernels/field.py::k2_core; csrc/field_bwd_wgmma.cuh's k2w::fits): wgmma
# at widths 128 and 256 with CP up to 128, mma.sync elsewhere, none for the
# f32 build
@pytest.mark.parametrize("depth,width,ins_num,dtype,core", [
    (8, 256, 32, torch.bfloat16, "wgmma"),        # dmsr_k32, the flagship
    (8, 256, 64, torch.bfloat16, "wgmma"),        # replica_k64: CP 80
    (8, 256, 123, torch.bfloat16, "wgmma"),       # CP 128
    (8, 128, 65, torch.bfloat16, "wgmma"),        # replica64_stress
    (16, 256, 123, torch.bfloat16, "wgmma"),      # the deepest trunk
    (2, 128, 3, torch.bfloat16, "wgmma"),
    (8, 192, 32, torch.bfloat16, "mma_sync"),     # HW 96: not whole 64-column blocks
    (8, 64, 11, torch.bfloat16, "mma_sync"),      # W 64
    (8, 64, 123, torch.bfloat16, "mma_sync"),
    (3, 32, 3, torch.bfloat16, "mma_sync"),       # W 32
    (8, 160, 32, torch.bfloat16, "mma_sync"),
    (8, 256, 32, torch.float32, None),            # the f32 build: its own core
    (8, 64, 11, torch.float32, None),
])
def test_k2_core_by_shape(depth, width, ins_num, dtype, core):
    cfg = tf.FieldConfig(netdepth=depth, netwidth=width, multires=10, multires_views=4,
                         ins_num=ins_num, compute_dtype=dtype)
    packed = pack_field(tf.DMNeRFField(cfg), slabs=False)
    assert kf.k2_core(kf.layout(packed), packed.w.dtype) == core


def test_reset_launches_clears_the_core_counts():
    kf.K2_CORES["wgmma"], kf.K2_CORES["mma_sync"] = 3, 2
    kf.LAUNCHES["field_backward"] = 5
    kf.reset_launches()
    assert kf.K2_CORES == {"wgmma": 0, "mma_sync": 0}
    assert not any(kf.LAUNCHES.values())


def test_flatten_inputs_and_validation():
    pts = torch.zeros(4, 5, 3)
    p, d, ppd = kf.flatten_inputs(pts, torch.zeros(4, 1, 3))
    assert p.shape == (20, 3) and d.shape == (4, 3) and ppd == 5
    p, d, ppd = kf.flatten_inputs(pts, torch.zeros(4, 5, 3))
    assert d.shape == (20, 3) and ppd == 1
    with pytest.raises(ValueError):
        kf.flatten_inputs(pts, torch.zeros(2, 1, 3))
    _, _, f32_field = _pair("f32")
    _, _, field = _pair("bf16")
    packed = pack_field(field)
    p, d, _ = kf.flatten_inputs(pts, torch.zeros(4, 1, 3))
    g = torch.zeros(20, field.cfg.ins_num + 5)
    kf._check(packed, p, d, g)                               # the accepted form
    kf._check(pack_field(f32_field), p, d, g)                # and its f32 build's
    with pytest.raises(TypeError, match="field kernels: no kernel build"):
        kf._check(packed._replace(w=packed.w.half()), p, d)
    with pytest.raises(TypeError):
        kf._check(packed, p.double(), d)
    with pytest.raises(ValueError):
        kf._check(packed, p, d, g[:, :4])
    with pytest.raises(ValueError):
        kf._check(packed, p.T.contiguous().T, d)
    with pytest.raises(ValueError):
        kf.field_forward(packed, pts.to("meta"), torch.zeros(4, 1, 3, device="meta"))
    with pytest.raises(ValueError):
        kf.make_pallas_field(f32_field.cfg)(field, pts, torch.zeros(4, 1, 3))
    # the limits K1/K2 share with K3-K5 (render_field.check_kernel_shape): up
    # to ins_num 123 (CP 128) at any width (replica64_stress: 65 at 128), no
    # layer wider than 256
    wide = dict(netdepth=2, netwidth=256, multires=10, multires_views=4)
    for width, ins_num in ((256, 64), (256, 123), (128, 65), (64, 123)):
        shape = tf.FieldConfig(**{**wide, "netwidth": width}, ins_num=ins_num)
        kf._check(pack_field(tf.DMNeRFField(shape)), p, d, torch.zeros(20, ins_num + 5))
    for over, limit in (({"ins_num": 124}, r"\(ins_num 124\) must be at most 128"),
                        ({"ins_num": 4, "netwidth": 288}, "netwidth 288 must be at most 256")):
        wp = pack_field(tf.DMNeRFField(tf.FieldConfig(**{**wide, **over})))
        with pytest.raises(ValueError, match="field kernels: .*" + limit):
            kf._check(wp, p, d)


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("part", ["sigma", "ins", "all", "backward"])
@pytest.mark.parametrize("over", [{}, dict(netdepth=8, netwidth=256, multires=10,
                                           multires_views=4, ins_num=32, skip=4)])
def test_chip_smoke_counts_the_field_layers(part, over):
    """chip_smoke.py's bounds count one multiply-add per weight of the layers
    a kernel runs, per point: every Linear for the whole field, the trunk and
    density for K4, and those and the instance branch for K5. K2's backward
    is dW, one product per weight, and dX: the heads back to their hidden
    layers, the hidden layers back to their trunk columns (not the view
    encoding), the density head and the rgb feature layer back to the trunk
    (the instance branch reads it detached), and the trunk's layers after the
    first back to their trunk columns (the points need no gradient)."""
    field = tf.DMNeRFField(tf.FieldConfig(**{**CFG, **over}))
    weights = {n[:-len(".weight")]: p for n, p in field.named_parameters()
               if n.endswith("weight")}
    if part == "backward":
        W = field.cfg.netwidth
        dx = (sum(weights[n].numel() for n in ("rgb_linear", "ins_linear",
                                                "ins_feature_linears.0", "density_linear",
                                                "rgb_feature_linear"))
              + weights["rgb_feature_linears.0"].shape[0] * W
              + sum(w.shape[0] * W for n, w in weights.items()
                    if n.startswith("mlps.") and n != "mlps.0"))
        want = dx + sum(w.numel() for w in weights.values())
    else:
        heads = {"sigma": ("mlps.", "density_linear"),
                 "ins": ("mlps.", "density_linear", "ins_"),
                 "all": ("",)}[part]
        want = sum(w.numel() for n, w in weights.items() if n.startswith(heads))
    assert _chip_smoke().field_macs(field.cfg, part) == want
