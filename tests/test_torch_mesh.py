"""The port's mesh extraction (dmnerf_torch/mesh/extract.py) vs the JAX
package's on the CPU: the density query, the vertex labels on both routes,
and the whole pipeline down to its two PLY files.

The same weights (a JAX init, carried across by state_dict_from_jax) and the
same numpy inputs go through both packages. On the CPU the port's kernel
wrappers run their plain versions; JAX's fused route runs its Pallas kernels
in interpret mode.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dmnerf_tpu.config import default_config
from dmnerf_tpu.mesh import extract as jextract
from dmnerf_tpu.mesh.ply import read_ply as jax_read_ply
from dmnerf_tpu.models import fields as jf
from dmnerf_torch.eval.renderer import make_batch_renderer
from dmnerf_torch.kernels import field as kf
from dmnerf_torch.kernels import render_field as krf
from dmnerf_torch.mesh import extract as textract
from dmnerf_torch.mesh.grid import grid_within_bound
from dmnerf_torch.mesh.marching import marching_cubes
from dmnerf_torch.mesh.ply import read_ply
from dmnerf_torch.models import fields as tf
from dmnerf_torch.models.convert import state_dict_from_jax

NET = dict(netdepth=3, netwidth=32, multires=4, multires_views=2)
# A label may differ where the two packages' f32 sums can order the top two
# instance probabilities either way, or where a ray's last sample (distance
# 1e10, so its alpha is a step in sign(sigma)) has a density within
# SIGMA_STEP of 0 (ROADMAP.md queue 3's hazards). Such rays are exempt, and
# they may be at most MAX_EXEMPT of all rays.
PROB_TIE = 1e-4
SIGMA_STEP = 1e-3
MAX_EXEMPT = 0.02


def _setup(precision="f32", seed=2, mesh_level=0.45):
    """JAX and port field pairs from one JAX init; seed 2 gives a non-empty
    isosurface on the 20^3 grid of the end-to-end test."""
    args = default_config(N_test=32, N_samples=8, N_importance=8, near=1.0, far=12.0,
                          precision=precision, mesh_grid_dim=20, mesh_level=mesh_level,
                          mesh_extents="8,8,8", expname="tiny", **NET)
    args.ins_num = 4
    cfg_j, cfg_t = jf.FieldConfig.from_args(args), tf.FieldConfig.from_args(args)
    pj = {k: jf.init_field_params(jax.random.PRNGKey(2 * seed + i), cfg_j)
          for i, k in enumerate(("coarse", "fine"))}
    pt = {}
    for k, v in pj.items():
        pt[k] = tf.DMNeRFField(cfg_t)
        pt[k].load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, v)))
    return args, cfg_j, pj, cfg_t, pt


def _rays(pt, cfg_t, args, n, seed):
    """n vertex rays, drawn from a seed, of the isosurface of the fine field
    on the 20^3 grid (the port's density, marching cubes and normals)."""
    grid, _ = grid_within_bound([-1.0, 1.0], np.full(3, 8.0), np.eye(4), 20)
    q = grid[:, [0, 2, 1]].copy()
    q[:, 1] *= -1
    sigma = textract.make_density_fn(cfg_t, 4096, device="cpu", use_pallas=False)(
        pt["fine"], q.astype(np.float32))
    occ = 1.0 - np.exp(-np.maximum(sigma, 0.0) * (args.far - args.near) / args.N_importance)
    verts, faces, _ = marching_cubes(occ.reshape(20, 20, 20), 0.45)
    ro, rd = textract.vertex_rays((verts / 19 - 0.5) * 8.0, faces, args.near)
    sel = np.random.default_rng(seed).choice(len(ro), n, replace=False)
    return ro[sel], rd[sel]


def _exempt(pt, cfg_t, args, ro, rd):
    """Rays whose label may differ between the packages: top two instance
    probabilities within PROB_TIE (the plain unfused render) or either field's
    density at the last sample (z = LABEL_FAR) within SIGMA_STEP of 0."""
    n = ro.shape[0]
    render = make_batch_renderer(cfg_t, args.N_samples, args.N_importance,
                                 textract.LABEL_NEAR, textract.LABEL_FAR, n, n,
                                 device="cpu")
    with torch.no_grad():
        _, ins, _ = render(pt, torch.from_numpy(ro), torch.from_numpy(rd))
        top2 = torch.topk(ins, 2, dim=-1).values
        last = torch.from_numpy(ro + rd * textract.LABEL_FAR)
        sig = torch.stack([pt[k].density(last)[:, 0] for k in ("coarse", "fine")])
    return ((top2[:, 0] - top2[:, 1] < PROB_TIE)
            | (sig.abs() < SIGMA_STEP).any(0)).numpy()


def _labels_agree(got, want, exempt):
    assert got.dtype == np.int32 and got.shape == want.shape
    assert exempt.mean() <= MAX_EXEMPT, exempt.mean()
    np.testing.assert_array_equal(got[~exempt], want[~exempt])


@pytest.mark.parametrize("use_pallas", [True, False])
def test_density_matches_jax_f32(use_pallas):
    """f32: only the order of f32 summation differs; within 1e-5 of max
    |sigma|. The batch (100 points) leaves a partial last batch."""
    args, cfg_j, pj, cfg_t, pt = _setup()
    pts = np.random.default_rng(0).uniform(-4, 4, (1000, 3)).astype(np.float32)
    want = jextract.make_density_fn(cfg_j, 64)(pj["fine"], pts)
    kf.reset_launches()
    got = textract.make_density_fn(cfg_t, 100, device="cpu", use_pallas=use_pallas)(
        pt["fine"], pts)
    assert sum(kf.LAUNCHES.values()) == 0          # the plain version on the CPU
    assert got.dtype == np.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_density_matches_jax_bf16():
    """bf16 operands, f32 accumulation: tests/test_torch_field.py's bars for
    raw (a one-ulp flip of a stored activation moves a value by up to 2e-2;
    the median stays at f32 rounding)."""
    args, cfg_j, pj, cfg_t, pt = _setup("bf16")
    pts = np.random.default_rng(1).uniform(-4, 4, (1000, 3)).astype(np.float32)
    want = jextract.make_density_fn(cfg_j, 64)(pj["fine"], pts)
    got = textract.make_density_fn(cfg_t, 256, device="cpu", use_pallas=True)(
        pt["fine"], pts)
    err = np.abs(got - want)
    assert err.max() <= 2e-2, err.max()
    assert np.median(err) <= 1e-6, np.median(err)


def test_density_refuses_another_config():
    args, _, _, cfg_t, pt = _setup()
    other = dataclasses.replace(cfg_t, ins_num=5)
    with pytest.raises(ValueError, match="FieldConfig"):
        textract.make_density_fn(other, 64, device="cpu", use_pallas=True)(
            pt["fine"], np.zeros((4, 3), np.float32))


def test_labels_unfused_match_jax():
    """The plain coarse->fine render against JAX's unfused one on 200 rays
    (chunk 32: the last chunk padded); labels equal off the exempt rays."""
    args, cfg_j, pj, cfg_t, pt = _setup()
    ro, rd = _rays(pt, cfg_t, args, 200, seed=3)
    want = jextract.make_label_fn(cfg_j, args, 32, use_fused=False)(pj, ro, rd)
    got = textract.make_label_fn(cfg_t, args, 32, device="cpu", use_pallas=False)(pt, ro, rd)
    _labels_agree(got, np.asarray(want), _exempt(pt, cfg_t, args, ro, rd))


def test_labels_fused_match_jax_fused():
    """The port's fused route (K4 + K3's plain versions on the CPU) against
    JAX's use_fused=True (its Pallas kernels in interpret mode) on 60 rays.
    JAX's fused composite takes the transmittance through exp/log and so
    differs from core/rendering.composite at f32 rounding (PARITY.md:117-125);
    the exemption absorbs the ties that moves."""
    args, cfg_j, pj, cfg_t, pt = _setup()
    ro, rd = _rays(pt, cfg_t, args, 60, seed=4)
    want = jextract.make_label_fn(cfg_j, args, 32, use_fused=True)(pj, ro, rd)
    krf.reset_launches()
    got = textract.make_label_fn(cfg_t, args, 32, device="cpu", use_pallas=True)(pt, ro, rd)
    assert sum(krf.LAUNCHES.values()) == 0
    _labels_agree(got, np.asarray(want), _exempt(pt, cfg_t, args, ro, rd))


def test_extract_mesh_matches_jax(tmp_path, capsys):
    """The whole pipeline in f32 on a 20^3 grid: a non-empty isosurface with
    the same faces, vertices within 1e-4 (extents 8: a vertex moves by the f32
    difference of the density where the grid crosses the level), labels equal
    off the exempt rays, and both PLY files read back the same by the other
    package's reader."""
    args, cfg_j, pj, cfg_t, pt = _setup()
    vj, fj, lj = jextract.extract_mesh(pj, cfg_j, args, None, str(tmp_path / "jax"))
    vt, ft, lt = textract.extract_mesh(pt, cfg_t, args, None, str(tmp_path / "torch"),
                                       device="cpu")
    assert len(ft) > 0 and lt is not None
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, atol=1e-4, rtol=0)
    assert lt.shape == (len(vt),)

    _labels_agree(lt, np.asarray(lj).astype(np.int32),
                  _exempt(pt, cfg_t, args, *textract.vertex_rays(vt, ft, args.near)))

    for name in ("tiny.ply", "color_tiny.ply"):
        vt2, ft2 = jax_read_ply(str(tmp_path / "torch" / name))
        vj2, fj2 = read_ply(str(tmp_path / "jax" / name))
        np.testing.assert_array_equal(ft2, fj2)
        np.testing.assert_allclose(vt2, vj2, atol=1e-4, rtol=0)
    assert f"{len(vt)} verts, {len(ft)} faces" in capsys.readouterr().out


def test_extract_mesh_empty_isosurface(tmp_path, capsys):
    """A level no occupancy reaches: both packages print and return no
    labels and no coloured mesh."""
    args, cfg_j, pj, cfg_t, pt = _setup(mesh_level=1.5)
    vt, ft, lt = textract.extract_mesh(pt, cfg_t, args, None, str(tmp_path), device="cpu")
    vj, fj, lj = jextract.extract_mesh(pj, cfg_j, args, None, str(tmp_path))
    assert len(ft) == len(fj) == 0 and lt is None and lj is None
    assert capsys.readouterr().out.count("extract_mesh: empty isosurface") == 2
    assert not os.path.exists(tmp_path / "color_tiny.ply")
