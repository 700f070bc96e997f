"""The port's ray mesh (dmnerf_torch/parallel/mesh.py) on the CPU over gloo:
ranks started as processes of tests/torch_parallel_ranks.py (one group per
world size, each under a 120 s timeout), against the JAX package's
single-device step and against one rank of the port; the split checks;
world size 1 equal to no mesh bit for bit; and the CLIs under torchrun."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmnerf_tpu.core import rendering as jrend
from dmnerf_tpu.core.rays import rays_at_pixels as jax_rays_at_pixels
from dmnerf_tpu.core.sampling import z_val_sample as jax_z_val_sample
from dmnerf_tpu.data.synthetic import make_scene
from dmnerf_tpu.losses.emptiness import ins_penalizer as jax_ins_penalizer
from dmnerf_tpu.losses.instance import ins_criterion_pair as jax_ins_pair
from dmnerf_tpu.losses.photometric import img2mse as jax_img2mse
from dmnerf_tpu.models import fields as jf
from dmnerf_tpu.ops.pallas.field_kernels import make_trainable_pallas_field as jax_ptf
from dmnerf_tpu.train.step import make_optimizer as jax_make_optimizer
from dmnerf_torch.models import fields as tf
from dmnerf_torch.models.convert import state_dict_from_jax
from dmnerf_torch.parallel import mesh as pm

import torch_parallel_ranks as ranks
from syncing_forms import bincount_gt_onehot, gt_label_set

GT_LABEL_SETS = [(kind, n) for n in (32, 64) for kind in ("all", "gaps", "single")]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
run_ranks, one_process = ranks.run_ranks, ranks.one_process


def _jax_fields(args, seed=0):
    cfg_j = jf.FieldConfig.from_args(args)
    return cfg_j, {k: jf.init_field_params(jax.random.PRNGKey(seed + i), cfg_j)
                   for i, k in enumerate(("coarse", "fine"))}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The world-2 group of train_render_edit, its one-process reference
    (mesh=None) and the JAX fields (a) starts from."""
    args = ranks.tiny_args(perturb=0.0)
    args.ins_num = make_scene(H=8, W=8, n_train=1, n_test=1).ins_num
    cfg_j, pj = _jax_fields(args)
    inputs = {"fields": {k: state_dict_from_jax(jax.tree.map(np.asarray, v))
                         for k, v in pj.items()},
              "gt_labels": {key: gt_label_set(*key) for key in GT_LABEL_SETS}}
    got = run_ranks("train_render_edit", 2, tmp_path_factory.mktemp("w2"), inputs)
    return got, one_process("train_render_edit", inputs), (args, cfg_j, pj)


def test_two_ranks_step_matches_jax_step(two_ranks):
    """(a) One step at world size 2, perturb off, penalizer on, from the
    JAX fields on all 64 pixels of an 8x8 view, against the JAX package's
    single-device step (render_rays + the losses + optax.adam on the
    interpret-mode Pallas field), with test_train_step_matches_jax_step's
    bars: they absorb the order of f32 sums (here also over the ranks),
    which can move an importance sample by ~1e-6. Loss and metrics 1e-4
    relative, gradients 1e-3 relative L2 per parameter, the Adam update
    within 1e-6 where the gradient is above 1e-7. Both ranks hold the same
    gradients and parameters bit for bit."""
    got, _, (args, cfg_j, pj) = two_ranks
    scene = make_scene(H=8, W=8, n_train=1, n_test=1)
    ro, rd = jax_rays_at_pixels(jnp.arange(64), 8, jnp.asarray(scene.K, jnp.float32),
                                jnp.asarray(scene.poses[0]))
    target_c = jnp.asarray(scene.images[0].reshape(-1, 3))
    target_i = jnp.asarray(scene.gt_labels[0].reshape(-1))
    field = jax_ptf(cfg_j)

    def loss_fn(params):
        out = jrend.render_rays(lambda p, v: field(params["coarse"], p, v),
                                lambda p, v: field(params["fine"], p, v), ro, rd,
                                jax_z_val_sample(64, 1.0, 12.0, 8), 8, key=None, perturb=False)
        rgb_loss = (jax_img2mse(out["rgb_fine"], target_c)
                    + jax_img2mse(out["rgb_coarse"], target_c))
        lc, lf = jax_ins_pair(out["ins_coarse"], out["ins_fine"], target_i, args.ins_num,
                              logits_coarse=out["ins_logits_coarse"],
                              logits_fine=out["ins_logits_fine"])
        total = rgb_loss + lc.total + lf.total
        for s in ("coarse", "fine"):
            total = total + jax_ins_penalizer(out[f"raw_{s}"], out[f"z_vals_{s}"],
                                              out[f"depth_{s}"], rd, 0.05, 0.05)
        return total, {"rgb_loss": rgb_loss, "ins_loss": lc.total + lf.total}

    (jtotal, jm), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(pj)
    tx = jax_make_optimizer(args.lrate, args.lrate_decay)
    updates, _ = tx.update(jgrads, tx.init(pj), pj)
    jnew = optax.apply_updates(pj, updates)

    for r in got:
        np.testing.assert_allclose(r["a_metrics"]["total_loss"], float(jtotal), rtol=1e-4)
        for k in ("rgb_loss", "ins_loss"):
            np.testing.assert_allclose(r["a_metrics"][k], float(jm[k]), rtol=1e-4)
    names = [(key, n) for key in ("coarse", "fine")
             for n, _ in tf.DMNeRFField(tf.FieldConfig.from_args(args)).named_parameters()]
    want_g = {k: state_dict_from_jax(jax.tree.map(np.asarray, jgrads[k])) for k in jgrads}
    want_p = {k: state_dict_from_jax(jax.tree.map(np.asarray, jnew[k])) for k in jnew}
    for (key, name), g, p in zip(names, got[0]["a_grads"], got[0]["a_params"]):
        wg, wp = want_g[key][name], want_p[key][name]
        assert float((g - wg).norm() / wg.norm().clamp_min(1e-30)) <= 1e-3, (key, name)
        live = wg.abs() > 1e-7
        assert float(torch.where(live, (p - wp).abs(), 0.0).max()) <= 1e-6, (key, name)
    for a, b in zip(got[0]["a_grads"] + got[0]["a_params"],
                    got[1]["a_grads"] + got[1]["a_params"]):
        assert torch.equal(a, b)


def test_two_ranks_steps_match_one_rank(two_ranks):
    """(b) Three steps at world size 2 with perturb and the penalizer on
    (the ranks draw the global jitter and inverse-CDF uniforms and take
    their rows): after every step both ranks hold bit-identical parameters
    and Adam moments, and these match one rank's within the order of f32
    sums over the ranks: losses 1e-6 relative, parameters 1e-6 absolute
    (Adam at lr 5e-3 moves a parameter by up to ~5e-3 a step, and a
    gradient near zero whose sign the sum order flipped would move its
    update most)."""
    got, ref, _ = two_ranks
    for step, (s0, s1, sr) in enumerate(zip(got[0]["b_steps"], got[1]["b_steps"],
                                            ref["b_steps"])):
        assert s0["metrics"] == s1["metrics"], step
        for a, b in zip(s0["params"], s1["params"]):
            assert torch.equal(a, b), step
        for (ma, va), (mb, vb) in zip(s0["moments"], s1["moments"]):
            assert torch.equal(ma, mb) and torch.equal(va, vb), step
        for k, v in sr["metrics"].items():
            np.testing.assert_allclose(s0["metrics"][k], v, rtol=1e-6, err_msg=f"{step} {k}")
        worst = max(float((a - b).abs().max()) for a, b in zip(s0["params"], sr["params"]))
        assert worst <= 1e-6, (step, worst)


def test_sharded_render_and_edit_match_one_rank(two_ranks):
    """(d) A render of an 8x8 view at N_test 32 (16 rays per rank per
    chunk) through the fused renderer, the unfused one and the per-chunk
    renderer, and a 2-object edit (rigid + deform, dryrun_multichip's third
    path) of the whole image and of one chunk, at world size 2 against one
    rank: rgb within 1e-5 and labels equal (that dry run's bars; each ray's
    work does not depend on the other rays, so they hold with room), on
    both ranks."""
    got, ref, _ = two_ranks
    for r in got:
        for key in ("render_fused", "render_unfused", "render_chunks", "edit", "edit_chunk"):
            for a, b in zip(r[key], ref[key]):
                a, b = np.asarray(a), np.asarray(b)
                assert a.shape == b.shape and a.dtype == b.dtype, key
                if np.issubdtype(a.dtype, np.integer):
                    np.testing.assert_array_equal(a, b, err_msg=key)
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=key)


def test_sharded_manipulator_eval_writes_on_rank_zero(two_ranks):
    """edit/runner.manipulator_eval at world size 2: rank 0 returns and
    writes one rank's PSNR and AP (test_results.txt to its printed 6
    digits), rank 1 edits its rows and writes nothing."""
    got, ref, _ = two_ranks
    (psnr, ap), table = got[0]["mani_eval"]
    (want_psnr, want_ap), want_table = ref["mani_eval"]
    np.testing.assert_allclose(psnr, want_psnr, rtol=1e-6)
    np.testing.assert_array_equal(ap, want_ap)
    assert table == want_table
    assert got[1]["mani_eval"] == (None, None)


def test_metrics_read_on_every_rank_agree(two_ranks):
    """(f) tools/dryrun_two_proc.py's check: the metrics of the sharded
    steps, read on every rank, are finite and the same on each."""
    got, _, _ = two_ranks
    for s0, s1 in zip(got[0]["b_steps"], got[1]["b_steps"]):
        assert all(np.isfinite(v) for v in s0["metrics"].values())
        assert s0["metrics"] == s1["metrics"]


@pytest.mark.parametrize("key", GT_LABEL_SETS)
def test_label_presence_over_two_ranks_equals_the_bincount_form(two_ranks, key):
    """build_gt_onehot on each rank's half of a label set, the counts summed
    over the ranks: the one-hot rows, row mask and count of the bincount form
    on the whole set."""
    got, _, _ = two_ranks
    gt, row_valid, valid_num = bincount_gt_onehot(gt_label_set(*key), key[1])
    half = len(gt) // 2
    for r, g in enumerate(got):
        rgt, rvalid, rnum = g["gt_onehot"][key]
        assert torch.equal(rgt, gt[r * half:(r + 1) * half])
        assert torch.equal(rvalid, row_valid) and torch.equal(rnum, valid_num)


def test_put_and_broadcast_helpers(two_ranks):
    """put_sharded gives each rank its rows of a host array on its device;
    put_replicated and broadcast_object give every rank rank 0's value."""
    got, _, _ = two_ranks
    host = torch.arange(12.0, dtype=torch.float64).reshape(6, 2)
    for r, g in enumerate(got):
        assert torch.equal(g["put_sharded"], host[3 * r:3 * (r + 1)])
        assert torch.equal(g["put_replicated"], torch.zeros(3, dtype=torch.float64))
        assert g["broadcast_object"] == "rank 0"


def test_four_ranks_crop_step_matches_one_rank(tmp_path):
    """(c) One crop-sampler step at world size 4, perturb and the penalizer
    on: the 12 labeled rays span ranks 2 and 3, ranks 0 and 1 contribute
    zeros to the instance statistics. Every rank holds the same parameters;
    losses within 1e-6 relative of one rank's, gradients within 2e-6
    relative L2 (the order of f32 sums over four ranks)."""
    got = run_ranks("crop_step", 4, tmp_path, {})
    ref = one_process("crop_step", {})
    for r in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r["params"], got[0]["params"]))
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got[0]["metrics"][k], v, rtol=1e-6, err_msg=k)
    for g, w in zip(got[0]["grads"], ref["grads"]):
        assert float((g - w).norm() / w.norm().clamp_min(1e-30)) <= 2e-6


def test_world_size_one_equals_no_mesh_bit_for_bit(tmp_path):
    """A DataMesh of one rank (a real gloo group) gives the numbers of
    mesh=None bit for bit: train steps, render and edit."""
    args = ranks.tiny_args(perturb=0.0)
    args.ins_num = ranks.make_scene(H=8, W=8, n_train=1, n_test=1).ins_num
    cfg = tf.FieldConfig.from_args(args)
    g = torch.Generator().manual_seed(2)
    inputs = {"fields": {k: tf.init_field_params(g, cfg).state_dict()
                         for k in ("coarse", "fine")}}
    (got,) = run_ranks("train_render_edit", 1, tmp_path, inputs)
    ref = one_process("train_render_edit", inputs)
    assert got["a_metrics"] == ref["a_metrics"]
    assert got["b_steps"][-1]["metrics"] == ref["b_steps"][-1]["metrics"]
    for a, b in zip(got["a_grads"] + got["a_params"] + got["b_steps"][-1]["params"],
                    ref["a_grads"] + ref["a_params"] + ref["b_steps"][-1]["params"]):
        assert torch.equal(a, b)
    for key in ("render_fused", "render_unfused", "render_chunks", "edit", "edit_chunk"):
        for a, b in zip(got[key], ref[key]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), key


def _split_case(case):
    from dmnerf_torch.edit.manipulator import make_image_manipulator
    from dmnerf_torch.eval.renderer import make_image_renderer
    from dmnerf_torch.train.step import make_train_step

    mesh = pm.DataMesh(rank=0, size=3, device=torch.device("cpu"))
    args = ranks.tiny_args(N_test=64)
    args.ins_num = 4
    cfg = tf.FieldConfig.from_args(args)
    if case == "data_devices":
        pm.check_data_devices(3, 2)
    elif case == "N_train":
        make_train_step(args, cfg, mesh=mesh)
    elif case == "N_test render":
        make_image_renderer(cfg, args, 8, 8, device="cpu", mesh=mesh)
    elif case == "N_test edit":
        make_image_manipulator(cfg, None, args, 1, [1], 64, mesh=mesh)


@pytest.mark.parametrize("case, match", [
    ("data_devices", "--data_devices 3 does not match the world size 2"),
    ("N_train", "N_train 64 does not split over the world size 3"),
    ("N_test render", "N_test 64 does not split over the world size 3"),
    ("N_test edit", "N_test 64 does not split over the world size 3")])
def test_split_checks_raise(case, match):
    """(e) --data_devices other than 0 or the world size, and N_train or
    N_test that does not split over the ranks, raise naming both numbers."""
    with pytest.raises(ValueError, match=match):
        _split_case(case)


def test_data_devices_accepts_zero_and_the_world_size():
    assert pm.check_data_devices(0, 4) == 4 and pm.check_data_devices(4, 4) == 4


def test_cli_data_devices_mismatch_raises_before_the_group(tmp_path, monkeypatch):
    """(e) Under torchrun's variables cli.train refuses --data_devices 3 at
    world size 2 before it joins a process group."""
    from dmnerf_torch.cli.train import main as train_main
    import torch.distributed as dist

    cfg = _cli_config(tmp_path, n_iters=1)
    for k, v in dict(WORLD_SIZE=2, RANK=0, LOCAL_RANK=0, MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=ranks.free_port()).items():
        monkeypatch.setenv(k, str(v))
    with pytest.raises(ValueError, match="--data_devices 3 does not match the world size 2"):
        train_main(["--config", str(cfg), "--device", "cpu", "--data_devices", "3"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("name, local_rank, want", [
    ("cpu", 3, "cpu"), ("cuda", 1, None), ("cuda:0", 1, None)])
def test_mesh_device_rule(name, local_rank, want):
    """cpu stays cpu; cuda is cuda:{LOCAL_RANK} and an explicit cuda:N is
    used as given, and either raises when that card is not there."""
    if want is not None:
        assert pm.mesh_device(name, local_rank) == torch.device(want)
    elif torch.cuda.device_count() > max(local_rank, 0):
        assert pm.mesh_device(name, local_rank).index == (
            local_rank if name == "cuda" else 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            pm.mesh_device(name, local_rank)


def test_rows_split_the_batch_contiguously():
    meshes = [pm.DataMesh(r, 4, torch.device("cpu")) for r in range(4)]
    x = torch.arange(24)
    assert torch.equal(torch.cat([pm.shard_batch(x, m) for m in meshes]), x)
    assert [pm.rank_share(24, m, "N") for m in meshes] == [6] * 4
    assert pm.shard_batch(x, None) is x and pm.rank_share(24, None, "N") == 24


def _cli_config(tmp_path, n_iters):
    cfg = tmp_path / "c.txt"
    cfg.write_text("\n".join([
        "expname = cli", f"basedir = {tmp_path / 'logs'}", "log_time = run",
        "datadir = ./data/synthetic/boxroom16x4", "N_train = 64", "N_samples = 8",
        "N_importance = 8", "N_test = 64", "near = 1.0", "far = 12.0", "penalize",
        "tolerance = 0.05", "deta_w = 0.05", f"n_iters = {n_iters}", "i_print = 2",
        "i_save = 4", "i_test = 4", "eval_views = 1"]
        + [f"{k} = {v}" for k, v in ranks.NET.items()]) + "\n")
    return cfg


def test_torchrun_cli_train_render_mesh_over_two_ranks(tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2` of cli.train
    (6 steps, an in-train eval at step 4), then of cli.test --render and
    --mesh, on the CPU, against the same runs in one process: rank 0 alone
    writes metrics.jsonl (the same steps), the checkpoints and the evals;
    the weights match one process's within the order of f32 sums (2e-5
    after 6 steps) and test_results.txt within 1e-3 of PSNR
    (a mean over 256 pixels of nearly equal renders); the mesh is written
    once."""
    from dmnerf_torch.cli.test import main as test_main
    from dmnerf_torch.cli.train import main as train_main
    from dmnerf_torch.models.convert import load_tar

    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir(), two.mkdir()
    train_main(["--config", str(_cli_config(one, 5)), "--device", "cpu"])
    cfg2 = _cli_config(two, 5)
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", "-m"]
    env = ranks.rank_env()
    for argv in (["dmnerf_torch.cli.train", "--config", str(cfg2), "--device", "cpu",
                  "--data_devices", "2"],
                 ["dmnerf_torch.cli.test", "--config", str(cfg2), "--render", "--device",
                  "cpu"],
                 ["dmnerf_torch.cli.test", "--config", str(cfg2), "--mesh", "--device", "cpu",
                  "--mesh_grid_dim", "16", "--mesh_extents", "12,12,12"]):
        proc = subprocess.run(torchrun + argv, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=ranks.GROUP_TIMEOUT)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    test_main(["--config", str(_cli_config(one, 5)), "--render", "--device", "cpu"])

    l1, l2 = one / "logs" / "cli" / "run", two / "logs" / "cli" / "run"
    m1 = [json.loads(l) for l in open(l1 / "metrics.jsonl")]
    m2 = [json.loads(l) for l in open(l2 / "metrics.jsonl")]
    assert [l["step"] for l in m2] == [l["step"] for l in m1] == [2, 4, 6]
    for a, b in zip(m1, m2):
        np.testing.assert_allclose(a["total_loss"], b["total_loss"], rtol=1e-5)
    assert {"000004.tar", "000006.tar", "testset_000004", "render_test_000006"} <= set(
        os.listdir(l2))
    for sd1, sd2 in zip(load_tar(str(l1 / "000006.tar"))[:2], load_tar(str(l2 / "000006.tar"))[:2]):
        assert max(float((sd1[k] - sd2[k]).abs().max()) for k in sd1) <= 2e-5
    t1 = np.loadtxt(l1 / "render_test_000006" / "test_results.txt")
    t2 = np.loadtxt(l2 / "render_test_000006" / "test_results.txt")
    np.testing.assert_allclose(t2[:, 0], t1[:, 0], atol=1e-3)
    assert sorted(os.listdir(l2 / "mesh_000006")) == ["cli.ply", "color_cli.ply"]
