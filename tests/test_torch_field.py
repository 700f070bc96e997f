"""dmnerf_torch field, encoding and weight bridge vs the JAX package (CPU).

The same weights (a JAX init, carried across by state_dict_from_jax) and the
same numpy inputs go through apply_field and DMNeRFField.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmnerf_tpu.core.encoding import positional_encoding as pe_jax
from dmnerf_tpu.models import fields as jf
from dmnerf_torch.core.encoding import encoding_dim, positional_encoding
from dmnerf_torch.models import fields as tf
from dmnerf_torch.models.convert import load_tar, save_tar, state_dict_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

SMALL = dict(netdepth=3, netwidth=32, multires=4, multires_views=2, ins_num=4, skip=1)


def _pair(dtype_j, dtype_t, seed=0, **over):
    kw = {**SMALL, **over}
    cfg_j = jf.FieldConfig(**kw, compute_dtype=dtype_j)
    cfg_t = tf.FieldConfig(**kw, compute_dtype=dtype_t)
    params = jf.init_field_params(jax.random.PRNGKey(seed), cfg_j)
    field = tf.DMNeRFField(cfg_t)
    field.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return cfg_j, params, field


def _points(n=64, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, (n, 6, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 1, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return pts, vd


@pytest.mark.parametrize("multires", [0, 2, 10])
def test_positional_encoding_matches_jax(multires):
    """Same channel order and values; sin/cos of two libraries differ by at
    most a few f32 ulps at arguments up to |x|*2^9 (tolerance 2e-6 abs)."""
    x = np.random.default_rng(0).uniform(-4, 4, (50, 3)).astype(np.float32)
    got = positional_encoding(torch.from_numpy(x), multires).numpy()
    want = np.asarray(pe_jax(jnp.asarray(x), multires))
    assert got.shape == want.shape == (50, encoding_dim(multires))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_field_f32_matches_apply_field():
    """f32: only the order of f32 summation differs (tolerance 1e-5)."""
    cfg_j, params, field = _pair(jnp.float32, torch.float32)
    pts, vd = _points()
    want = np.asarray(jf.apply_field(params, cfg_j, jnp.asarray(pts), jnp.asarray(vd)))
    got = field(torch.from_numpy(pts), torch.from_numpy(vd)).detach().numpy()
    assert got.shape == (64, 6, 4 + SMALL["ins_num"] + 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_field_bf16_matches_apply_field():
    """bf16 operands, f32 accumulation, bf16 stores at the same places. The
    products are exact on both sides; a different f32 summation order can
    flip a stored activation by one bf16 ulp (2^-8 relative), which the next
    layers carry. Bound: 2e-2 abs on outputs of magnitude ~1-5, and the
    median error stays at f32 rounding level."""
    cfg_j, params, field = _pair(jnp.bfloat16, torch.bfloat16)
    pts, vd = _points()
    want = np.asarray(jf.apply_field(params, cfg_j, jnp.asarray(pts), jnp.asarray(vd)))
    got = field(torch.from_numpy(pts), torch.from_numpy(vd)).detach().numpy()
    assert got.dtype == np.float32
    err = np.abs(got - want)
    assert err.max() <= 2e-2, err.max()
    assert np.median(err) <= 1e-6, np.median(err)


def test_density_is_the_forward_sigma_column():
    """DMNeRFField.density (the sigma kernel's plain path) == forward[..., 3]."""
    _, _, field = _pair(jnp.bfloat16, torch.bfloat16)
    pts, vd = _points(n=8)
    pts, vd = torch.from_numpy(pts), torch.from_numpy(vd)
    torch.testing.assert_close(field.density(pts)[..., 0], field(pts, vd)[..., 3],
                               rtol=0, atol=0)


def test_instance_branch_is_detached_from_trunk():
    """A loss on the instance logits gives the trunk exactly zero gradient."""
    _, _, field = _pair(jnp.float32, torch.float32)
    pts, vd = _points(n=8)
    raw = field(torch.from_numpy(pts), torch.from_numpy(vd))
    raw[..., 4:].square().sum().backward()
    for layer in field.mlps:
        assert layer.weight.grad is None or not layer.weight.grad.any()
    assert field.ins_linear.weight.grad.abs().sum() > 0


def test_state_dict_from_jax_matches_export_tool():
    """The port's bridge == tools/export_torch_ckpt.params_to_state_dict."""
    from export_torch_ckpt import params_to_state_dict

    cfg = jf.FieldConfig(**SMALL, compute_dtype=jnp.float32)
    params = jf.init_field_params(jax.random.PRNGKey(3), cfg)
    want = params_to_state_dict(params)
    got = state_dict_from_jax(jax.tree.map(np.asarray, params))
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # and the names are exactly the module's own
    assert list(tf.DMNeRFField(tf.FieldConfig(**SMALL)).state_dict()) == list(want)


def test_tar_roundtrip(tmp_path):
    _, _, coarse = _pair(jnp.float32, torch.float32, seed=0)
    _, _, fine = _pair(jnp.float32, torch.float32, seed=1)
    path = str(tmp_path / "000123.tar")
    save_tar(path, coarse.state_dict(), fine.state_dict(), 123)
    blob = torch.load(path, weights_only=True)
    assert set(blob) == {"iteration", "network_coarse_state_dict",
                         "network_fine_state_dict", "optimizer_state_dict"}
    c, f, it = load_tar(path)
    assert it == 123
    for a, b in ((c, coarse.state_dict()), (f, fine.state_dict())):
        assert all(torch.equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("scheme", ["he", "torch"])
def test_init_field_params_bounds_and_seed(scheme):
    cfg = tf.FieldConfig(**SMALL)
    a = tf.init_field_params(torch.Generator().manual_seed(5), cfg, scheme)
    b = tf.init_field_params(torch.Generator().manual_seed(5), cfg, scheme)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    for m in a.modules():
        if isinstance(m, torch.nn.Linear):
            fan_in = m.in_features
            wb = (6.0 / fan_in) ** 0.5 if scheme == "he" else fan_in ** -0.5
            assert m.weight.abs().max() <= wb and m.bias.abs().max() <= fan_in ** -0.5
    with pytest.raises(ValueError):
        tf.init_field_params(torch.Generator(), cfg, "xavier")


def test_skip_after_last_layer_rejected():
    with pytest.raises(ValueError):
        tf.DMNeRFField(tf.FieldConfig(**{**SMALL, "skip": 2}))


def test_from_args_precision():
    from dmnerf_tpu.config import default_config
    args = default_config(netdepth=2, netwidth=32, multires=4, multires_views=2)
    args.ins_num = 3
    assert tf.FieldConfig.from_args(args).compute_dtype == torch.bfloat16
    args.precision = "f32"
    cfg = tf.FieldConfig.from_args(args)
    assert cfg.compute_dtype == torch.float32 and cfg.ins_num == 3
