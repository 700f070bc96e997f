"""The port's losses vs the JAX package's, value and gradient: img2mse /
mse2psnr, build_gt_onehot, cost_matrices (with and without logits),
ins_criterion_pair (matching included) and ins_penalizer. Float64 on both
sides (jax.enable_x64), where the only difference is the order
of f64 sums: 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from dmnerf_tpu.losses import emptiness as je
from dmnerf_tpu.losses import instance as ji
from dmnerf_tpu.losses import photometric as jp
from dmnerf_torch.losses import emptiness as te
from dmnerf_torch.losses import instance as ti
from dmnerf_torch.losses import photometric as tp
from syncing_forms import bincount_gt_onehot, gt_label_set

TOL = dict(rtol=1e-9, atol=1e-12)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64, requires_grad=True)


def test_img2mse_and_psnr():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(size=(50, 3)), rng.uniform(size=(50, 3))
    with jax.enable_x64(True):
        want = jax.value_and_grad(lambda x: jp.mse2psnr(jp.img2mse(x, jnp.asarray(b))))(
            jnp.asarray(a))
        ta = _t(a)
        got = tp.mse2psnr(tp.img2mse(ta, torch.from_numpy(b)))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want[0]), **TOL)
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want[1]), **TOL)


@pytest.mark.parametrize("labels", [[3, 0, 3, 5, 5, 1], [2, 2, 2], list(range(8))])
def test_build_gt_onehot(labels):
    gt, rv, n = ti.build_gt_onehot(torch.tensor(labels), 8)
    wgt, wrv, wn = ji.build_gt_onehot(jnp.asarray(labels), 8)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wgt))
    np.testing.assert_array_equal(rv.numpy(), np.asarray(wrv))
    assert int(n) == int(wn)


@pytest.mark.parametrize("kind", ["all", "gaps", "single", "none"])
@pytest.mark.parametrize("ins_num", [32, 64])
def test_build_gt_onehot_equals_the_bincount_form(kind, ins_num):
    """The presence counted by a scatter of ones gives the bincount form's
    one-hot, row mask and count."""
    labels = gt_label_set(kind, ins_num)
    got, want = ti.build_gt_onehot(labels, ins_num), bincount_gt_onehot(labels, ins_num)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _ins_inputs(N=40, K=6, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(N, K)) * 2.0
    return logits, 1.0 / (1.0 + np.exp(-logits)), rng.integers(0, K - 2, N)


@pytest.mark.parametrize("with_logits", [False, True])
def test_cost_matrices(with_logits):
    logits, pred, labels = _ins_inputs()
    with jax.enable_x64(True):
        gt = np.asarray(ji.build_gt_onehot(jnp.asarray(labels), 6)[0], np.float64)

        def f_jax(p, lg):
            ce, si = ji.cost_matrices(p, jnp.asarray(gt), lg if with_logits else None)
            return jnp.sum(ce * jnp.arange(36.0).reshape(6, 6)) + jnp.sum(si ** 2), (ce, si)

        (_, (ce, si)), (gp, gl) = jax.value_and_grad(f_jax, argnums=(0, 1), has_aux=True)(
            jnp.asarray(pred), jnp.asarray(logits))
    tpred, tlog = _t(pred), _t(logits)
    tce, tsi = ti.cost_matrices(tpred, torch.from_numpy(gt), tlog if with_logits else None)
    (torch.sum(tce * torch.arange(36.0, dtype=torch.float64).reshape(6, 6))
     + torch.sum(tsi ** 2)).backward()
    np.testing.assert_allclose(tce.detach().numpy(), np.asarray(ce), **TOL)
    np.testing.assert_allclose(tsi.detach().numpy(), np.asarray(si), **TOL)
    np.testing.assert_allclose(tpred.grad.numpy(), np.asarray(gp), **TOL)
    if with_logits:
        np.testing.assert_allclose(tlog.grad.numpy(), np.asarray(gl), **TOL)
    else:
        assert tlog.grad is None


@pytest.mark.parametrize("seed", [0, 1])
def test_ins_criterion_pair(seed):
    """Both losses and their gradients; the host assignment is lap_square's
    on these tie-free costs (tests/test_torch_lap.py)."""
    lc, pc, labels = _ins_inputs(seed=seed)
    lf, pf, _ = _ins_inputs(seed=seed + 10)
    with jax.enable_x64(True):
        def f_jax(pc_, pf_, lc_, lf_):
            a, b = ji.ins_criterion_pair(pc_, pf_, jnp.asarray(labels), 6, lc_, lf_)
            return a.total + 2.0 * b.total, (a, b)

        (_, (wa, wb)), wg = jax.value_and_grad(f_jax, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(x) for x in (pc, pf, lc, lf)))
    ts = [_t(x) for x in (pc, pf, lc, lf)]
    ga, gb = ti.ins_criterion_pair(ts[0], ts[1], torch.tensor(labels), 6, ts[2], ts[3])
    (ga.total + 2.0 * gb.total).backward()
    for got, want in ((ga, wa), (gb, wb)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.item(), float(w), **TOL)
    for t, w in zip(ts, wg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)


def test_ins_penalizer():
    """Value and gradient of the penalizer (the custom-VJP BCE on both
    sides) on a raw whose samples straddle the depth, so both regions are
    populated; depth is detached on both sides."""
    rng = np.random.default_rng(3)
    R, S, C = 12, 16, 4 + 5 + 1
    raw = rng.normal(size=(R, S, C)) * 3.0
    z = np.sort(rng.uniform(1.0, 6.0, (R, S)), -1)
    depth = rng.uniform(2.0, 5.0, R)
    rays_d = rng.normal(size=(R, 3))
    with jax.enable_x64(True):
        wv, (wg, wd) = jax.value_and_grad(
            lambda r, d: je.ins_penalizer(r, jnp.asarray(z), d, jnp.asarray(rays_d), 0.3, 0.2),
            argnums=(0, 1))(jnp.asarray(raw), jnp.asarray(depth))
    traw, tdepth = _t(raw), _t(depth)
    got = te.ins_penalizer(traw, torch.from_numpy(z), tdepth, torch.from_numpy(rays_d), 0.3, 0.2)
    got.backward()
    np.testing.assert_allclose(got.item(), float(wv), **TOL)
    np.testing.assert_allclose(traw.grad.numpy(), np.asarray(wg), **TOL)
    assert tdepth.grad is None and not np.asarray(wd).any()


def test_bce_core_backward_is_the_derivative_of_its_forward():
    """_BCECore's transcendental-free backward vs autograd of the same
    forward written out (f64)."""
    rng = np.random.default_rng(4)
    raw = _t(rng.normal(size=(5, 7, 9)) * 4.0)
    wb, wm = (torch.from_numpy(rng.uniform(size=(5, 7))) for _ in range(2))
    te._BCECore.apply(raw, wb, wm).backward()
    x = raw.detach().clone().requires_grad_(True)
    ins, air = te._masks(x)
    ref = torch.sum(torch.nn.functional.softplus(x) * (ins * wb[..., None] + air * wm[..., None])
                    - x * air * wb[..., None])
    ref.backward()
    np.testing.assert_allclose(raw.grad.numpy(), x.grad.numpy(), **TOL)
