"""The port's edit path vs the JAX package on the CPU: kernel K5's plain
version, the exchanger, manipulate_chunk, the pose image manipulator, the
manipulation eval/demo runners and the test CLI's --mani_eval/--mani_demo on
a tiny DM-SR fixture. Inputs come from numpy seeds; weights cross from JAX
through state_dict_from_jax. K5 itself runs on a card only:
tests/test_torch_cuda.py."""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmnerf_tpu.config import default_config
from dmnerf_tpu.core import rendering as jrend
from dmnerf_tpu.data.synthetic import make_scene
from dmnerf_tpu.edit import manipulator as jm
from dmnerf_tpu.edit import runner as jrun
from dmnerf_tpu.edit.deform import deform_scale
from dmnerf_tpu.edit.transforms import _center_conjugate, _mode_matrix, generate_poses_demo
from dmnerf_tpu.models import fields as jf
from dmnerf_tpu.ops.pallas import render_field as jrf
from dmnerf_torch.edit import manipulator as tm
from dmnerf_torch.edit import runner as trun
from dmnerf_torch.kernels import field as kf
from dmnerf_torch.kernels import render_field as krf
from dmnerf_torch.models import fields as tf
from dmnerf_torch.models.convert import save_tar, state_dict_from_jax

SMALL = dict(netdepth=3, netwidth=32, multires=4, multires_views=2, ins_num=4, skip=1)


def _field(seed=0, dtype_t=torch.float32, **over):
    kw = {**SMALL, **over}
    cfg_j = jf.FieldConfig(**kw, compute_dtype=jnp.float32)
    params = jf.init_field_params(jax.random.PRNGKey(seed), cfg_j)
    field = tf.DMNeRFField(tf.FieldConfig(**kw, compute_dtype=dtype_t))
    field.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return cfg_j, params, field


def _pair(**over):
    """A coarse/fine pair in both frameworks: (cfg_j, params_j, cfg_t, params_t)."""
    cfg_j, pc, fc = _field(0, **over)
    _, pf, ff = _field(1, **over)
    return cfg_j, {"coarse": pc, "fine": pf}, fc.cfg, {"coarse": fc, "fine": ff}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


# ---- K5's plain version -------------------------------------------------------

def test_ins_ref_matches_jax_kernel_and_composite():
    """K5's plain version vs the Pallas heads='ins' kernel (interpret, f32)
    and vs apply_field + composite(keep_air).ins_logits: 1e-5 abs (f32
    summation order and the Pallas exp/log transmittance), as K3's test."""
    cfg_j, params, field = _field(2)
    rng = np.random.default_rng(3)
    R, S = 16, 70
    ro = (rng.normal(size=(R, 3)) * 0.1).astype(np.float32)
    rd = (rng.normal(size=(R, 3)) * rng.uniform(0.8, 1.2, (R, 1))).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 6.0, (R, S)), -1).astype(np.float32)
    pts = ro[:, None] + rd[:, None] * z[..., None]
    with torch.no_grad():
        got = krf.render_field_ins_ref(field, _t(pts), _t(z), _t(rd)).numpy()
    kern = np.asarray(jrf.make_render_field(cfg_j, heads="ins")(
        params, jnp.asarray(pts), jnp.asarray(z), jnp.asarray(rd)))
    vd = jnp.asarray(rd / np.linalg.norm(rd, axis=-1, keepdims=True))[:, None]
    raw = jf.apply_field(params, cfg_j, jnp.asarray(pts), vd)
    comp = np.asarray(jrend.composite(raw, jnp.asarray(z), jnp.asarray(rd),
                                      keep_air=True).ins_logits)
    assert got.shape == (R, SMALL["ins_num"] + 1)
    np.testing.assert_allclose(got, kern, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, comp, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_heads_equal_forward_columns(dtype):
    """DMNeRFField.instance is forward's columns 3: bit for bit."""
    _, _, field = _field(4, dtype_t=dtype)
    pts = _t(np.random.default_rng(5).normal(size=(6, 9, 3)).astype(np.float32))
    vd = _t(np.random.default_rng(6).normal(size=(6, 1, 3)).astype(np.float32))
    with torch.no_grad():
        sigma, ins = field.instance(pts)
        raw = field(pts, vd)
    assert torch.equal(torch.cat([sigma, ins], -1), raw[..., 3:])


# ---- exchanger ----------------------------------------------------------------

K = 3
C = 4 + K + 1


def _raw_for(labels, logit=8.0):
    labels = np.asarray(labels)
    raw = np.zeros(labels.shape + (C,), np.float32)
    raw[..., 3] = 1.0
    np.put_along_axis(raw[..., 4:], labels[..., None], logit, -1)
    return raw


def _accum_for(labels):
    a = np.full((len(labels), K + 1), 0.1, np.float32)
    a[np.arange(len(labels)), labels] = 0.9
    return a


def _tied(rng, shape):
    """Logits from {0, 1, 2}: most points and rays hold tied maxima."""
    return rng.integers(0, 3, shape + (C,)).astype(np.float32)


# (ori labels, tar labels, ori accum, tar accum, move labels): the cases of
# tests/test_manipulator.py, then random inputs full of ties
CASES = {
    "eliminate": ([[1, 1]], [[[0, 0]]], [1], [[0]], [1]),
    "exchange": ([[0, 0]], [[[1, 1]]], [0], [[1]], [1]),
    "keep": ([[0, 2]], [[[0, 0]]], [0], [[0]], [1]),
    "occlusion_fix": ([[1, 1]], [[[0, 0]]], [2], [[0]], [1]),
    "filling": ([[0, 0]], [[[2, 2]]], [1], [[0]], [1]),
    "two_objects": ([[1, 2, 0, 1]], [[[0, 1, 1, 2]], [[2, 2, 0, 0]]], [1], [[0], [2]], [1, 2]),
}


@pytest.mark.parametrize("case", list(CASES) + ["ties_one", "ties_two"])
def test_exchanger_is_bitwise_jax(case):
    """The exchanger's decisions are argmaxes: torch.argmax and jnp.argmax
    both take the first of tied maxima, so the outputs are equal bit for bit,
    ties included (random logits from {0, 1, 2})."""
    if case in CASES:
        ori_l, tar_ls, ori_a, tar_as, moves = CASES[case]
        ori = _raw_for(ori_l)
        tars = [_raw_for(t) for t in tar_ls]
        ori_acc, tar_accs = _accum_for(ori_a), [_accum_for(a) for a in tar_as]
        # distinct values per point, so a swap or a zero shows in the output
        ori[..., :3] = np.arange(ori[..., :3].size).reshape(ori[..., :3].shape)
    else:
        rng = np.random.default_rng(7)
        moves = [1] if case == "ties_one" else [1, 2]
        ori = _tied(rng, (32, 10))
        tars = [_tied(rng, (32, 10)) for _ in moves]
        ori_acc = rng.integers(0, 3, (32, K + 1)).astype(np.float32)
        tar_accs = [rng.integers(0, 3, (32, K + 1)).astype(np.float32) for _ in moves]
    want = np.asarray(jm.exchanger(jnp.asarray(ori), [jnp.asarray(t) for t in tars],
                                   jnp.asarray(ori_acc), [jnp.asarray(a) for a in tar_accs],
                                   moves))
    got = tm.exchanger(_t(ori), [_t(t) for t in tars], _t(ori_acc),
                       [_t(a) for a in tar_accs], moves).numpy()
    np.testing.assert_array_equal(got, want)
    if case not in CASES:
        assert not np.array_equal(got, ori)          # the edit did something


# ---- manipulate_chunk -------------------------------------------------------------

def _chunk_rays(n_obj, N=24, seed=10):
    rng = np.random.default_rng(seed)
    ori_o = (rng.normal(size=(N, 3)) * 0.3).astype(np.float32)
    ori_d = rng.normal(size=(N, 3)).astype(np.float32)
    shifts = [np.array([0.3, -0.1, 0.2]), np.array([-0.2, 0.25, 0.0])]
    tars = [((ori_o + shifts[i]).astype(np.float32), ori_d) for i in range(n_obj)]
    return (ori_o, ori_d), tars


@pytest.mark.parametrize("n_obj", [1, 2])
def test_manipulate_chunk_matches_jax(n_obj):
    """The port's plain path vs JAX's in f32, 1 and 2 objects: all four
    outputs within 2e-4 (PARITY surface 14). The K5 route (plain version on
    the CPU) agrees with the raw + composite route within 1e-5. Three chained
    det samplings scale the two libraries' cumsum rounding by 1/pdf
    (test_torch_core); on these rays the worst output differs by 5e-5."""
    cfg_j, pj, cfg_t, pt = _pair()
    (oo, od), tars = _chunk_rays(n_obj)
    moves = [1, 2][:n_obj]
    kw = dict(n_samples=8, n_importance=8, near=1.0, far=6.0)
    want = jm.manipulate_chunk(
        lambda p, v: jf.apply_field(pj["coarse"], cfg_j, p, v),
        lambda p, v: jf.apply_field(pj["fine"], cfg_j, p, v),
        (jnp.asarray(oo), jnp.asarray(od)),
        [(jnp.asarray(o), jnp.asarray(d)) for o, d in tars], moves, **kw)
    with torch.no_grad():
        got = tm.manipulate_chunk(pt["coarse"], pt["fine"], (_t(oo), _t(od)),
                                  [(_t(o), _t(d)) for o, d in tars], moves, **kw)
    # the K5 route: make_manipulator with use_pallas (K1's and K5's wrappers,
    # their plain versions on the CPU)
    k5 = tm.make_manipulator(cfg_t, pt, SimpleNamespace(
        N_samples=8, N_importance=8, near=1.0, far=6.0), n_obj, moves, use_pallas=True)(
        _t(oo), _t(od), torch.stack([_t(o) for o, _ in tars]),
        torch.stack([_t(d) for _, d in tars]))
    for g, w, k in zip(got, want, k5):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=0)
        np.testing.assert_allclose(k.numpy(), g.numpy(), atol=1e-5, rtol=0)


# ---- the pose image manipulator --------------------------------------------------

def _args(**over):
    kw = dict(N_test=16, N_samples=8, N_importance=8, near=1.0, far=12.0,
              precision="f32", netdepth=3, netwidth=32, multires=4, multires_views=2)
    return default_config(**{**kw, **over})


def _scene_pair(H, W, n_test=1, **over):
    scene = make_scene(H=H, W=W, n_train=1, n_test=n_test)
    args = _args(**over)
    args.ins_num = scene.ins_num
    cfg_j, pj, cfg_t, pt = _pair(**{k: getattr(args, k) for k in
                                    ("netdepth", "netwidth", "multires", "multires_views")},
                                 ins_num=scene.ins_num, skip=4)
    return scene, args, cfg_j, pj, cfg_t, pt


@pytest.mark.parametrize("use_pallas", [False, True])
def test_pose_image_manipulator_matches_jax(use_pallas):
    """Objects [rigid, deform 'sin'] on a 6x6 image (36 rays, chunk 16: the
    padding runs). rgb within 2e-4; labels equal and confidences within 2e-4
    (no pixel of this scene sits on an argmax tie). 16 + 16 samples keep the
    det samplings away from the flat cdf stretches where the two libraries'
    cumsum rounding moves a sample (8 + 8 reach 2.1e-4, 12 + 12 1e-3). use_pallas routes the
    port through K1's and K5's wrappers: their plain versions here."""
    H = W = 6
    scene, args, cfg_j, pj, cfg_t, pt = _scene_pair(H, W, N_samples=16, N_importance=16)
    objs = [{"mode": "rigid"}, {"mode": "deform", "deform_func": "sin"}]
    ori = np.asarray(scene.poses[0], np.float64)
    trans = np.eye(4)
    trans[:3, 3] = [0.3, -0.1, 0.2]
    tar_poses = np.stack([trans @ ori, ori])
    dscales = np.array([0.0, deform_scale("sin", 1)])
    want = jm.make_pose_image_manipulator(cfg_j, pj, args, objs, [1, 2], H, W, scene.K)(
        jnp.asarray(ori, jnp.float32), jnp.asarray(tar_poses, jnp.float32),
        jnp.asarray(dscales, jnp.float32))
    kf.reset_launches()
    krf.reset_launches()
    got = tm.make_pose_image_manipulator(cfg_t, pt, args, objs, [1, 2], H, W, scene.K,
                                         device="cpu", use_pallas=use_pallas)(
        ori, tar_poses, dscales)
    assert sum(kf.LAUNCHES.values()) == sum(krf.LAUNCHES.values()) == 0
    n = H * W
    assert [g.shape[0] for g in got] == [48] * 4
    assert [g.dtype for g in got] == [torch.float32, torch.int32, torch.int32, torch.float32]
    g = [x.numpy()[:n] for x in got]
    w = [np.asarray(x)[:n] for x in want]
    np.testing.assert_allclose(g[0], w[0], atol=2e-4, rtol=0)
    np.testing.assert_array_equal(g[1], w[1])
    np.testing.assert_array_equal(g[2], w[2])
    np.testing.assert_allclose(g[3], w[3], atol=2e-4, rtol=0)


def test_image_manipulator_is_chunk_invariant_and_checks_padding():
    """make_image_manipulator over chunks of 16 and of 64 rays gives the same
    image to f32 rounding (1e-5); a ray count off the chunk raises."""
    scene, args, _, _, cfg_t, pt = _scene_pair(8, 8)
    from dmnerf_torch.core.rays import get_rays
    ro, rd = (x.reshape(-1, 3).contiguous() for x in get_rays(
        8, 8, _t(scene.K).float(), _t(scene.poses[0]).float()))
    outs = [tm.make_image_manipulator(cfg_t, pt, args.replace(N_test=c), 1, [1], 64)(
        ro, rd, (ro + 0.2)[None], rd[None]) for c in (16, 64)]
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        tm.make_image_manipulator(cfg_t, pt, args, 1, [1], 40)


# ---- the runners ------------------------------------------------------------------

def _tables_close(a, b):
    """PSNR/SSIM within 1e-3, LPIPS NaN in both, AP columns equal."""
    assert a.shape == b.shape
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-3, rtol=0)
    assert np.isnan(a[:, 2]).all() and np.isnan(b[:, 2]).all()
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], atol=1e-6, rtol=0)


def _runner_setup():
    scene, args, cfg_j, pj, cfg_t, pt = _scene_pair(
        12, 12, n_test=2, N_test=144, N_samples=6, N_importance=6, netdepth=2,
        multires=3, target_label=1, mani_mode="translation", mani_type="rigid", views=2)
    return scene, args, cfg_j, pj, cfg_t, pt


def test_manipulator_eval_matches_jax(tmp_path):
    """manipulator_eval on the synthetic scene at 12x12 against the JAX
    runner (plain path, use_pallas False); the port through K1's/K5's
    wrappers (their plain versions here). The same png names, an equal
    matching_log.json and test_results.txt within tolerance."""
    scene, args, cfg_j, pj, cfg_t, pt = _runner_setup()
    trans = _center_conjugate(_mode_matrix("translation"), [0.0, 0.0, 0.0])
    trans_dicts = {"transformations": [{"transformation": trans.tolist(),
                                        "mode": "translation"}]}
    sel = scene.i_test
    kw = dict(gt_rgbs=scene.images[sel], gt_labels=scene.gt_labels[sel])
    want = jrun.manipulator_eval(cfg_j, pj, scene.poses[sel], scene.hwk, trans_dicts,
                                 str(tmp_path / "jax"), scene.ins_rgbs,
                                 args.replace(use_pallas=False), **kw)
    got = trun.manipulator_eval(cfg_t, pt, scene.poses[sel], scene.hwk, trans_dicts,
                                str(tmp_path / "torch"), scene.ins_rgbs,
                                args.replace(use_pallas=True), device="cpu", **kw)
    assert abs(got[0] - want[0]) <= 1e-3
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    dirs = [tmp_path / d / "translation" for d in ("torch", "jax")]
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    assert "1_ins_gt.png" in os.listdir(dirs[0])
    logs = [json.load(open(d / "matching_log.json")) for d in dirs]
    assert logs[0] == logs[1]
    _tables_close(*(np.loadtxt(d / "test_results.txt") for d in dirs))


def test_manipulator_eval_lpips_matches_jax(tmp_path):
    """manipulator_eval with --lpips_weights (random weights in the .npz
    layout) at 16x16, so that the last VGG tap is 1x1, against the JAX
    runner (this case raised until LPIPS was ported): the LPIPS column and
    its nanmean within 2e-6 (two units of the table's last digit; the edits
    differ at f32 rounding), every value finite. Without weights the column
    and its mean stay NaN (test_manipulator_eval_matches_jax)."""
    from dmnerf_torch.eval.lpips import random_weights

    weights = str(tmp_path / "lpips.npz")
    np.savez(weights, **random_weights(1))
    scene, args, cfg_j, pj, cfg_t, pt = _scene_pair(
        16, 16, n_test=2, N_test=256, N_samples=6, N_importance=6, netdepth=2,
        multires=3, target_label=1, mani_mode="translation", lpips_weights=weights)
    trans = _center_conjugate(_mode_matrix("translation"), [0.0, 0.0, 0.0])
    trans_dicts = {"transformations": [{"transformation": trans.tolist(),
                                        "mode": "translation"}]}
    sel = scene.i_test
    kw = dict(gt_rgbs=scene.images[sel], gt_labels=scene.gt_labels[sel])
    jrun.manipulator_eval(cfg_j, pj, scene.poses[sel], scene.hwk, trans_dicts,
                          str(tmp_path / "jax"), scene.ins_rgbs,
                          args.replace(use_pallas=False), **kw)
    trun.manipulator_eval(cfg_t, pt, scene.poses[sel], scene.hwk, trans_dicts,
                          str(tmp_path / "torch"), scene.ins_rgbs,
                          args.replace(use_pallas=True), device="cpu", **kw)
    a, b = (np.loadtxt(tmp_path / d / "translation" / "test_results.txt")
            for d in ("torch", "jax"))
    assert a.shape == b.shape == (3, 9)
    assert np.isfinite(a[:, 2]).all() and (a[:, 2] > 0).all()
    np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=0, atol=2e-6)


def test_manipulator_demo_matches_jax(tmp_path):
    """manipulator_demo with a rigid translation and a 'sin' deform for 2
    views against the JAX runner: the same png names, and every png's pixels
    equal but for at most 2 label pixels and rgb 8-bit steps of 1 (f32
    summation order) per view."""
    import imageio.v2 as imageio
    scene, args, cfg_j, pj, cfg_t, pt = _runner_setup()
    objs = [{"obj_name": "box1", "tar_id": 1, "mani_mode": "translation",
             "obj_center": [0.0, 0.0, 0.0], "distance": [0.5]},
            {"obj_name": "box2", "tar_id": 2, "mani_mode": "deform", "deform_func": "sin"}]
    objs_trans = generate_poses_demo(objs, args.replace(datadir=str(tmp_path)))
    poses = np.repeat(np.asarray(scene.poses[scene.i_test][:1]), 2, 0)
    jrun.manipulator_demo(cfg_j, pj, scene.hwk, objs_trans, str(tmp_path / "jax"),
                          scene.ins_rgbs, objs, poses, {"1": 1},
                          args.replace(use_pallas=False))
    trun.manipulator_demo(cfg_t, pt, scene.hwk, objs_trans, str(tmp_path / "torch"),
                          scene.ins_rgbs, objs, poses, {"1": 1},
                          args.replace(use_pallas=True), device="cpu")
    dirs = [tmp_path / d / "rigid" for d in ("torch", "jax")]
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) and len(names) == 6
    for name in names:
        a, b = (imageio.imread(d / name).astype(np.int64) for d in dirs)
        assert a.shape == b.shape
        if name.endswith("_rgb.png"):
            assert np.abs(a - b).max() <= 1
        else:
            assert (a != b).reshape(a.shape[0] * a.shape[1], -1).any(-1).sum() <= 2


def test_resolve_target_channel(monkeypatch):
    """--resolve_target_label: a GT label resolves to the channel that the
    Hungarian match binds it to (a renderer faked with a known permutation);
    a GT label in no view raises."""
    scene, args, _, _, cfg_t, pt = _runner_setup()
    perm = {int(l): int((l * 3 + 2) % scene.ins_num) for l in np.unique(scene.gt_labels)}
    poses = np.asarray(scene.poses)

    def fake_make_image_renderer(cfg_, args_, H, W, *, device, use_pallas=False, fused=None,
                                 mesh=None):
        def render_im(params, K, c2w):
            (vi,) = [i for i in range(len(poses)) if np.allclose(poses[i], c2w)]
            label = np.vectorize(perm.get)(np.asarray(scene.gt_labels[vi])).astype(np.int32)
            return (np.zeros(label.shape + (3,), np.float32), label,
                    np.full(label.shape, 0.9, np.float32), np.ones(label.shape, np.float32))
        return render_im

    from dmnerf_torch.eval import renderer
    monkeypatch.setattr(renderer, "make_image_renderer", fake_make_image_renderer)
    assert trun.resolve_target_channel(cfg_t, pt, args, scene, device="cpu") == perm[1]
    assert trun.resolve_target_channel(cfg_t, pt, args, scene, device="cpu",
                                       targets=[1, 2]) == {1: perm[1], 2: perm[2]}
    with pytest.raises(ValueError):
        trun.resolve_target_channel(cfg_t, pt, args.replace(target_label=scene.ins_num + 7),
                                    scene, device="cpu")


# ---- the CLI on a DM-SR fixture -----------------------------------------------------

def _dmsr_fixture(root, H=8, W=10, ins_num=4):
    """The DM-SR layout that data/dmsr.py and data/dmsr_mani.py read, with
    poses looking at the origin from 4 units away."""
    import h5py
    import imageio.v2 as imageio
    from dmnerf_tpu.edit.transforms import pose_spherical

    rng = np.random.default_rng(0)

    def views(base, n, poses):
        os.makedirs(os.path.join(base, "rgbs"), exist_ok=True)
        os.makedirs(os.path.join(base, "semantic_instance"), exist_ok=True)
        for i in range(n):
            imageio.imwrite(os.path.join(base, "rgbs", f"{i:03d}.png"),
                            rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
            imageio.imwrite(os.path.join(base, "semantic_instance", f"{i:03d}.png"),
                            rng.integers(0, ins_num, (H, W)).astype(np.uint8))
        return {"camera_angle_x": 0.8,
                "frames": [{"transform_matrix": p.tolist()} for p in poses]}

    poses = [pose_spherical(a, -30.0, 4.0) for a in (0.0, 40.0, 80.0)]
    for split, ps in (("train", poses[:1]), ("test", poses[1:])):
        meta = views(os.path.join(root, split), len(ps), ps)
        with open(os.path.join(root, split, "transforms.json"), "w") as f:
            json.dump(meta, f)
    meta = views(os.path.join(root, "mani", "translation"), 2, poses[1:])
    with open(os.path.join(root, "mani", "transforms.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(root, "mani", "obj_center.json"), "w") as f:
        json.dump({"center": [0.0, 0.0, 0.0]}, f)
    with open(os.path.join(root, "mani", "objs_info_rigid.json"), "w") as f:
        json.dump({"objects": [{"obj_name": "box1", "tar_id": 1,
                                "mani_mode": "translation", "obj_center": [0.0, 0.0, 0.0],
                                "distance": [0.5]}],
                   "view_id": 1, "ins_map": {"1": 1}}, f)
    with h5py.File(os.path.join(root, "ins_rgb.hdf5"), "w") as f:
        f.create_dataset("datasets", data=rng.integers(0, 255, (ins_num, 3), dtype=np.uint8))


def test_cli_mani_eval_and_demo_on_a_dmsr_fixture(tmp_path, capsys):
    """python -m dmnerf_torch.cli.test --mani_eval / --mani_demo --device cpu
    write the JAX package's artifacts; --resolve_target_label resolves first;
    --mesh still raises."""
    pytest.importorskip("imageio")
    from dmnerf_torch.cli.test import main
    from dmnerf_torch.models.fields import FieldConfig, init_field_params

    root = tmp_path / "dmsr" / "tiny"
    _dmsr_fixture(str(root))
    net = dict(netdepth=2, netwidth=32, multires=3, multires_views=2)
    cfg = tmp_path / "t.txt"
    cfg.write_text("\n".join([
        "expname = tiny", f"basedir = {tmp_path / 'logs'}", "log_time = run",
        f"datadir = {root}", "N_test = 32", "N_samples = 6", "N_importance = 6",
        "near = 1.0", "far = 8.0", "target_label = 1", "mani_mode = translation",
        "testskip = 1", "views = 2"] + [f"{k} = {v}" for k, v in net.items()]) + "\n")
    g = torch.Generator().manual_seed(0)
    fields = [init_field_params(g, FieldConfig(**net, ins_num=4)) for _ in range(2)]
    ldir = tmp_path / "logs" / "tiny" / "run"
    os.makedirs(ldir)
    save_tar(str(ldir / "000004.tar"), fields[0].state_dict(), fields[1].state_dict(), 4)

    savedir = main(["--config", str(cfg), "--mani_eval", "--device", "cpu"])
    assert savedir == str(ldir / "mani_eval_000004")
    out = os.path.join(savedir, "translation")
    assert sorted(os.listdir(out)) == sorted(
        [f"{i}_{k}.png" for i in range(2) for k in ("rgb", "ins", "rgb_gt", "ins_gt")]
        + ["matching_log.json", "test_results.txt"])
    table = np.loadtxt(os.path.join(out, "test_results.txt"))
    assert table.shape == (3, 9) and np.isfinite(table[:, 0]).all()
    assert os.path.exists(root / "mani" / "translation" / "transformation_matrix.json")
    assert "Manipulating Done" in capsys.readouterr().out

    main(["--config", str(cfg), "--mani_eval", "--device", "cpu", "--resolve_target_label"])
    assert "[MANI] resolved GT label 1 -> instance channel" in capsys.readouterr().out

    savedir = main(["--config", str(cfg), "--mani_demo", "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(savedir, "rigid"))) == sorted(
        f"{i}_{k}.png" for i in range(2) for k in ("rgb", "ins", "ins_pred_mask"))
    assert "box1" in json.load(open(root / "mani" / "transformation_matrix.json"))
    savedir = main(["--config", str(cfg), "--mesh", "--mesh_grid_dim", "16", "--device", "cpu"])
    assert savedir == str(ldir / "mesh_000004")
    assert "Meshing Done" in capsys.readouterr().out
