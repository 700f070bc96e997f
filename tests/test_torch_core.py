"""dmnerf_torch core (rays, sampling, compositing, render_rays) vs the JAX
package on the CPU, in f32, with numpy inputs from a seed fed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmnerf_tpu.core import rays as jr, rendering as jrend, sampling as js
from dmnerf_tpu.data.synthetic import make_scene
from dmnerf_tpu.models import fields as jf
from dmnerf_torch.core import rays as tr, rendering as trend, sampling as ts
from dmnerf_torch.models import fields as tf
from dmnerf_torch.models.convert import state_dict_from_jax
from syncing_forms import cumprod_alpha_weights

SMALL = dict(netdepth=3, netwidth=32, multires=4, multires_views=2, ins_num=4, skip=1)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_get_rays_and_rays_at_pixels_match_jax():
    """Exact up to one f32 rounding of the 3x3 rotation (tolerance 1e-6)."""
    scene = make_scene(H=6, W=7, n_train=1, n_test=1)
    K = scene.K.astype(np.float32)
    c2w = scene.poses[0]
    for a, b in zip(tr.get_rays(6, 7, _t(K), _t(c2w)),
                    jr.get_rays(6, 7, jnp.asarray(K), jnp.asarray(c2w))):
        assert a.shape == (6, 7, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    idx = np.random.default_rng(0).integers(0, 42, 20).astype(np.int32)
    for a, b in zip(tr.rays_at_pixels(_t(idx), 7, _t(K), _t(c2w)),
                    jr.rays_at_pixels(jnp.asarray(idx), 7, jnp.asarray(K), jnp.asarray(c2w))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)


def test_z_val_sample_matches_jax():
    """linspace of the two libraries may differ by one f32 ulp (tolerance 2e-6)."""
    got = ts.z_val_sample(5, 1.0, 12.0, 64)
    want = np.asarray(js.z_val_sample(5, 1.0, 12.0, 64))
    assert got.shape == (5, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("form", ["mask", "matmul"])
def test_sample_pdf_det_matches_both_jax_forms(form):
    """Det inverse-CDF vs each JAX form (they are bit-identical to each
    other). The cdf's cumsum runs in another order (1e-6 apart), and the
    inverse CDF scales that by 1/pdf: tolerance 1e-4 abs on bins in [0, 10]
    for rows with a pdf of ordinary size (incl. a uniform and an all-zero
    row). Where the pdf is ~0 over a long tail (row 2: zero weights past bin
    10) the inverse is ill-conditioned and the two may land anywhere in that
    tail, so there only the interval is checked."""
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(0, 10, (32, 65)), -1).astype(np.float32)
    w = rng.uniform(0.0, 2.0, (32, 64)).astype(np.float32)
    w[0] = 1.0
    w[1] = 0.0
    w[2, 10:] = 0.0
    got = ts.sample_pdf(_t(bins), _t(w), 128, det=True).numpy()
    want = np.asarray(js.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 128,
                                    key=None, det=True, form=form))
    assert got.shape == (32, 128)
    rows = np.arange(32) != 2
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-4, rtol=0)
    w2 = w[2].astype(np.float64) + 1e-5
    tail = np.linspace(0, 1, 128) > w2[:10].sum() / w2.sum() + 1e-5
    assert 0 < tail.sum() < 10
    np.testing.assert_allclose(got[2, ~tail], want[2, ~tail], atol=1e-4, rtol=0)
    for x in (got[2, tail], want[2, tail]):
        assert (x >= bins[2, 10] - 1e-4).all() and (x <= bins[2, -1] + 1e-4).all()


def test_sample_pdf_random_needs_generator_and_stays_in_range():
    """The random branch draws from a torch.Generator (JAX's keys give other
    numbers, so only the distribution's support and the seed are checked)."""
    bins = torch.linspace(1.0, 5.0, 17).expand(8, 17)
    w = torch.rand(8, 16, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        ts.sample_pdf(bins, w, 32)
    a = ts.sample_pdf(bins, w, 32, generator=torch.Generator().manual_seed(1))
    b = ts.sample_pdf(bins, w, 32, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.min() >= 1.0 and a.max() <= 5.0
    z = ts.perturb_z_vals(torch.Generator().manual_seed(2), bins)
    mids = 0.5 * (bins[:, 1:] + bins[:, :-1])
    assert (z[:, 1:-1] >= mids[:, :-1]).all() and (z[:, 1:-1] <= mids[:, 1:]).all()


def test_composite_matches_jax():
    """f32 composite; cumprod/sum orders differ (tolerance 1e-5 abs), with
    and without the air channel."""
    rng = np.random.default_rng(4)
    raw = rng.normal(size=(16, 24, 9)).astype(np.float32) * 2
    z = np.sort(rng.uniform(1, 6, (16, 24)), -1).astype(np.float32)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    for keep_air in (False, True):
        got = trend.composite(_t(raw), _t(z), _t(d), keep_air=keep_air)
        want = jrend.composite(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
                               keep_air=keep_air)
        for name in want._fields:
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


def _transmittance_inputs(case, S, dtype, R=24, seed=5):
    """(sigma, dists) [R, S]: random densities; with rows of opaque samples
    (alpha exactly 1); or with rows whose transmittance underflows to 0."""
    g = torch.Generator().manual_seed(seed)
    sigma = (torch.randn(R, S, generator=g, dtype=torch.float64) * 3).to(dtype)
    z = torch.sort(torch.rand(R, S, generator=g, dtype=torch.float64) * 5 + 1, -1)[0].to(dtype)
    d = torch.randn(R, 3, generator=g, dtype=torch.float64).to(dtype)
    if case == "opaque":
        sigma[::3, S // 2] = 1e30
        sigma[1::3, 0] = 1e30
    elif case == "underflow":
        sigma[::2] = 1e30
    dists = trend.sample_dists(z, d)
    if case != "random":
        assert (1.0 - torch.exp(-torch.relu(sigma) * dists) == 1.0).any()
    return sigma, dists


@pytest.mark.parametrize("case", ["random", "opaque", "underflow"])
@pytest.mark.parametrize("S", [64, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transmittance_equals_torch_cumprod(case, S, dtype):
    """The cumprod without the zero test (_CumprodNoZeros) gives torch.cumprod's
    values and gradients bit for bit at the coarse and fine sample counts, on
    rows with opaque samples and on rows whose transmittance underflows to 0;
    alpha_weights without grad is unchanged."""
    sigma, dists = _transmittance_inputs(case, S, dtype)
    x = torch.cat([torch.ones_like(sigma[..., :1]),
                   torch.exp(-torch.relu(sigma) * dists) + 1e-10], dim=-1)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1), dtype=dtype)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    got, want = trend._CumprodNoZeros.apply(xa), torch.cumprod(xb, dim=-1)
    assert torch.equal(got, want)
    (got * g).sum().backward()
    (want * g).sum().backward()
    assert torch.equal(xa.grad, xb.grad)
    if case == "underflow":
        assert (want[::2, -1] == 0).all()

    gw = g[:, :S]
    sa, sb = sigma.clone().requires_grad_(), sigma.clone().requires_grad_()
    wa, wb = trend.alpha_weights(sa, dists), cumprod_alpha_weights(sb, dists)
    assert torch.equal(wa, wb)
    (wa * gw).sum().backward()
    (wb * gw).sum().backward()
    assert torch.isfinite(sa.grad).all()
    assert torch.equal(sa.grad, sb.grad)
    with torch.no_grad():
        assert torch.equal(trend.alpha_weights(sigma, dists), cumprod_alpha_weights(sigma, dists))


def test_render_rays_det_matches_jax():
    """The unfused coarse->fine pipeline in f32 with the same weights.
    Outputs: 1e-4 abs (rgb, ins) and 1e-3 (depth, world units up to 6). The
    importance samples inherit sample_pdf's 1/pdf amplification of cumsum
    rounding: 5e-3 abs on z_vals_fine, where a sample moved in a low-weight
    stretch of the ray moves the composited outputs by far less."""
    cfg_j = jf.FieldConfig(**SMALL, compute_dtype=jnp.float32)
    cfg_t = tf.FieldConfig(**SMALL, compute_dtype=torch.float32)
    pj = {k: jf.init_field_params(jax.random.PRNGKey(s), cfg_j)
          for k, s in (("coarse", 0), ("fine", 1))}
    pt = {}
    for k, v in pj.items():
        pt[k] = tf.DMNeRFField(cfg_t)
        pt[k].load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, v)))
    rng = np.random.default_rng(3)
    ro = (rng.normal(size=(16, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(16, 3)).astype(np.float32)
    z = np.asarray(js.z_val_sample(16, 1.0, 6.0, 8))

    want = jax.jit(lambda ro, rd, z: jrend.render_rays(
        lambda p, v: jf.apply_field(pj["coarse"], cfg_j, p, v),
        lambda p, v: jf.apply_field(pj["fine"], cfg_j, p, v),
        ro, rd, z, 8, key=None, perturb=False))(jnp.asarray(ro), jnp.asarray(rd),
                                                jnp.asarray(z))
    with torch.no_grad():
        got = trend.render_rays(pt["coarse"], pt["fine"], _t(ro), _t(rd), _t(z), 8,
                                generator=None, perturb=False)
    for name, tol in (("rgb_fine", 1e-4), ("ins_fine", 1e-4), ("depth_fine", 1e-3),
                      ("z_vals_fine", 5e-3)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=tol, rtol=1e-4, err_msg=name)
