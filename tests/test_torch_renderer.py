"""The port's whole render slice vs the JAX package on the CPU (f32): the
image renderer (fused and unfused), render_test and its artifacts, and the
CLI from a `.tar` carried across from JAX params."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dmnerf_tpu.config import default_config
from dmnerf_tpu.core.rays import get_rays as get_rays_np
from dmnerf_tpu.data.synthetic import make_scene
from dmnerf_tpu.eval.renderer import make_image_renderer as jax_image_renderer
from dmnerf_tpu.eval.tester import render_test as jax_render_test
from dmnerf_tpu.models import fields as jf
from dmnerf_torch.eval.renderer import (make_batch_renderer, make_chunk_renderer,
                                        make_image_renderer, render_image)
from dmnerf_torch.eval.tester import render_test
from dmnerf_torch.kernels import field as kf
from dmnerf_torch.kernels import render_field as krf
from dmnerf_torch.models import fields as tf
from dmnerf_torch.models.convert import save_tar, state_dict_from_jax

# netdepth 6 so the skip concat (after layer 4) is on the path
NET = dict(netdepth=6, netwidth=32, multires=4, multires_views=2)


def _setup(H=8, W=8, n_test=2, N_test=32, **over):
    scene = make_scene(H=H, W=W, n_train=1, n_test=n_test)
    args = default_config(N_test=N_test, N_samples=8, N_importance=8, near=1.0,
                          far=12.0, precision="f32", **NET, **over)
    args.ins_num = scene.ins_num
    cfg_j = jf.FieldConfig.from_args(args)
    pj = {k: jf.init_field_params(jax.random.PRNGKey(s), cfg_j)
          for k, s in (("coarse", 0), ("fine", 1))}
    sds = {k: state_dict_from_jax(jax.tree.map(np.asarray, v)) for k, v in pj.items()}
    cfg_t = tf.FieldConfig.from_args(args)
    pt = {}
    for k, sd in sds.items():
        pt[k] = tf.DMNeRFField(cfg_t)
        pt[k].load_state_dict(sd)
    return scene, args, cfg_j, pj, cfg_t, pt, sds


# (rgb, label, conf, depth). Against either JAX path an importance sample can
# cross a bin: the cdf's cumsum runs in another order here, and the fused JAX
# path's transmittance goes through exp/log. That moves a pixel by ~1e-3
# (the bounds of tests/test_render_field.py:103-109).
MAX_TOL = (5e-3, 0, 5e-3, 5e-2)
# Against the unfused JAX path nothing else differs but the f32 summation
# order: all but at most 2 pixels per view stay within these.
PIXEL_TOL = (1e-4, 0, 1e-4, 1e-3)


def _assert_close(got, want, tight):
    for g, w, tol, tt in zip(got, want, MAX_TOL, PIXEL_TOL):
        np.testing.assert_allclose(g, w, atol=tol, rtol=6e-3 if tol else 0)
        if tight:
            err = np.abs(g.astype(np.float64) - w).reshape(g.shape[0] * g.shape[1], -1)
            assert (err.max(-1) > tt).sum() <= 2, (err.max(-1) > tt).sum()


@pytest.mark.parametrize("fused", [True, False])
def test_image_renderer_matches_jax(fused):
    scene, args, cfg_j, pj, cfg_t, pt, _ = _setup(n_test=3)
    render = make_image_renderer(cfg_t, args, 8, 8, device="cpu", use_pallas=fused,
                                 fused=fused)
    jax_unfused = jax_image_renderer(cfg_j, args, 8, 8, fused=False)
    jax_fused = jax_image_renderer(cfg_j, args, 8, 8, use_pallas=True)
    for pose in scene.poses[scene.i_test]:
        got = render(pt, scene.K, pose)
        assert [g.dtype for g in got] == [np.float32, np.int32, np.float32, np.float32]
        assert [g.shape for g in got] == [(8, 8, 3), (8, 8), (8, 8), (8, 8)]
        _assert_close(got, jax_unfused(pj, scene.K, pose), tight=True)
        if fused:
            _assert_close(got, jax_fused(pj, scene.K, pose), tight=False)


def test_fused_and_unfused_paths_agree_and_pad():
    """H*W = 70 rays over chunks of 32 (edge-padded); the fused chunk path
    (plain versions on the CPU) and the unfused render_rays path compute the
    same math in another order: 1e-4 on rgb/conf, labels equal."""
    scene, args, _, _, cfg_t, pt, _ = _setup(H=7, W=10)
    pose = scene.poses[scene.i_test[1]]
    a = make_image_renderer(cfg_t, args, 7, 10, device="cpu", use_pallas=True)(
        pt, scene.K, pose)
    b = make_image_renderer(cfg_t, args, 7, 10, device="cpu")(pt, scene.K, pose)
    for x, y, tol in zip(a, b, PIXEL_TOL):
        np.testing.assert_allclose(x, y, atol=tol, rtol=0)
    # legacy chunk renderer + render_image give the unfused numbers too
    rc = make_chunk_renderer(cfg_t, 8, 8, 1.0, 12.0, 32, device="cpu")
    rgb, ins, depth = render_image(rc, pt, 7, 10, scene.K, pose, 32, device="cpu")
    np.testing.assert_allclose(rgb, b[0], atol=1e-6)
    np.testing.assert_array_equal(np.argmax(ins, -1), b[1])


def test_render_many_matches_single_views():
    scene, args, _, _, cfg_t, pt, _ = _setup(n_test=3)
    r = make_image_renderer(cfg_t, args, 8, 8, device="cpu", use_pallas=True)
    poses = scene.poses[scene.i_test]
    many = list(r.many(pt, scene.K, poses))
    assert len(many) == 3
    for p, out in zip(poses, many):
        for x, y in zip(r(pt, scene.K, p), out):
            np.testing.assert_array_equal(x, y)


def test_unported_combinations_raise():
    """use_pallas with fused=False renders through K1's wrapper (on the CPU
    its plain version, DMNeRFField.forward: the module path's numbers
    exactly, and no launch); a ray count that is not a multiple of the chunk
    and --lpips_weights raise."""
    scene, args, _, _, cfg_t, pt, _ = _setup()
    rays = [torch.from_numpy(np.ascontiguousarray(np.asarray(r).reshape(-1, 3)))
            for r in get_rays_np(8, 8, scene.K, scene.poses[0])]
    krf.reset_launches()
    kf.reset_launches()
    got = make_batch_renderer(cfg_t, 8, 8, 1.0, 12.0, 32, 64, device="cpu",
                              use_pallas=True, fused=False)(pt, *rays)
    want = make_batch_renderer(cfg_t, 8, 8, 1.0, 12.0, 32, 64, device="cpu")(pt, *rays)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert sum(kf.LAUNCHES.values()) == sum(krf.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        make_batch_renderer(cfg_t, 8, 8, 1.0, 12.0, 32, 48, device="cpu")
    args.lpips_weights = "vgg.npz"
    with pytest.raises(NotImplementedError, match="LPIPS"):
        render_test(None, None, np.zeros((1, 4, 4)), (8, 8, None), args)


def _tables_close(a, b):
    """PSNR/SSIM columns within 1e-3 (rgb differs at the 1e-4 level); the
    LPIPS column NaN in both; AP columns equal (same labels, and confidences
    that differ only at f32 rounding order the objects alike)."""
    assert a.shape == b.shape
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-3, rtol=0)
    assert np.isnan(a[:, 2]).all() and np.isnan(b[:, 2]).all()
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], atol=1e-6, rtol=0)


def test_render_test_matches_jax(tmp_path):
    scene, args, cfg_j, pj, cfg_t, pt, _ = _setup()
    sel = scene.i_test
    kw = dict(gt_imgs=scene.images[sel], gt_labels=scene.gt_labels[sel],
              ins_rgbs=scene.ins_rgbs)
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "torch")
    want = jax_render_test(jax_image_renderer(cfg_j, args, 8, 8, fused=False), pj,
                           scene.poses[sel], scene.hwk, args,
                           savedir=str(tmp_path / "jax"), **kw)
    got = render_test(make_image_renderer(cfg_t, args, 8, 8, device="cpu",
                                          use_pallas=True), pt,
                      scene.poses[sel], scene.hwk, args,
                      savedir=str(tmp_path / "torch"), **kw)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    logs = [json.load(open(tmp_path / d / "matching_log.json")) for d in ("torch", "jax")]
    assert logs[0] == logs[1]
    _tables_close(*(np.loadtxt(tmp_path / d / "test_results.txt") for d in ("torch", "jax")))


def test_cli_render_from_converted_tar(tmp_path, capsys):
    """python -m dmnerf_torch.cli.test --render --device cpu on a `.tar`
    carried across from JAX params gives JAX's test_results.txt and
    matching_log.json (JAX rendered as its CLI does: use_pallas, fused)."""
    from dmnerf_tpu.data.base import load_dataset
    from dmnerf_torch.cli.test import main

    _, args, cfg_j, pj, _, _, sds = _setup()
    cfg = tmp_path / "t.txt"
    cfg.write_text("\n".join([
        "expname = cli", f"basedir = {tmp_path / 'logs'}", "log_time = run",
        "datadir = ./data/synthetic/boxroom8x4", "N_test = 32", "N_samples = 8",
        "N_importance = 8", "near = 1.0", "far = 12.0", "precision = f32"]
        + [f"{k} = {v}" for k, v in NET.items()]) + "\n")
    ldir = tmp_path / "logs" / "cli" / "run"
    os.makedirs(ldir)
    save_tar(str(ldir / "000007.tar"), sds["coarse"], sds["fine"], 7)
    save_tar(str(ldir / "000003.tar"), sds["fine"], sds["coarse"], 3)

    savedir = main(["--config", str(cfg), "--render", "--device", "cpu"])
    assert savedir == str(ldir / "render_test_000007")     # the latest .tar
    assert "Rendering Done" in capsys.readouterr().out

    scene = load_dataset(args.replace(datadir="./data/synthetic/boxroom8x4"))
    jdir = tmp_path / "jax"
    os.makedirs(jdir)
    sel = scene.i_test
    jax_render_test(jax_image_renderer(cfg_j, args, scene.H, scene.W, use_pallas=True),
                    pj, scene.poses[sel], scene.hwk, args, gt_imgs=scene.images[sel],
                    gt_labels=scene.gt_labels[sel], ins_rgbs=scene.ins_rgbs,
                    savedir=str(jdir))
    _tables_close(np.loadtxt(os.path.join(savedir, "test_results.txt")),
                  np.loadtxt(jdir / "test_results.txt"))
    assert (json.load(open(os.path.join(savedir, "matching_log.json")))
            == json.load(open(jdir / "matching_log.json")))

    # --test_model picks another .tar; a missing one raises; --mesh writes
    # mesh_NNNNNN/ for the newest .tar; --mani_eval goes to the DM-SR
    # manipulation loader, which finds no mani/ folder in the synthetic scene
    assert main(["--config", str(cfg), "--render", "--device", "cpu",
                 "--test_model", "000003.tar"]).endswith("render_test_000003")
    with pytest.raises(FileNotFoundError):
        main(["--config", str(cfg), "--render", "--device", "cpu", "--test_model", "5"])
    assert main(["--config", str(cfg), "--mesh", "--mesh_grid_dim", "16",
                 "--device", "cpu"]).endswith("mesh_000007")
    with pytest.raises(FileNotFoundError, match="mani"):
        main(["--config", str(cfg), "--mani_eval", "--device", "cpu"])


def test_cli_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from dmnerf_torch.cli.test import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", str(tmp_path / "none.txt"), "--render"])


def test_launch_counts_stay_zero_on_cpu():
    scene, args, _, _, cfg_t, pt, _ = _setup()
    krf.reset_launches()
    make_image_renderer(cfg_t, args, 8, 8, device="cpu", use_pallas=True)(
        pt, scene.K, scene.poses[0])
    assert sum(krf.LAUNCHES.values()) == 0
