"""The port's training slice on the CPU: the pixel samplers, one whole train
step vs a JAX step composed from render_rays + the losses + optax.adam with
the interpret-mode Pallas field, multi-step and resume replay, the Adam state
carried across from JAX, checkpoints, and the train CLI."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmnerf_tpu.config import default_config
from dmnerf_tpu.core import rendering as jrend
from dmnerf_tpu.core.rays import rays_at_pixels as jax_rays_at_pixels
from dmnerf_tpu.core.sampling import z_val_sample as jax_z_val_sample
from dmnerf_tpu.data.synthetic import make_scene, make_scene_crop
from dmnerf_tpu.losses.emptiness import ins_penalizer as jax_ins_penalizer
from dmnerf_tpu.losses.instance import ins_criterion_pair as jax_ins_pair
from dmnerf_tpu.losses.photometric import img2mse as jax_img2mse
from dmnerf_tpu.models import fields as jf
from dmnerf_tpu.ops.pallas.field_kernels import make_trainable_pallas_field as jax_ptf
from dmnerf_tpu.train.step import make_optimizer as jax_make_optimizer
from dmnerf_torch.models import fields as tf
from dmnerf_torch.models.convert import state_dict_from_jax, train_state_from_jax
from dmnerf_torch.train import checkpoint as ck
from dmnerf_torch.train.loop import train
from dmnerf_torch.train.schedule import make_optimizer
from dmnerf_torch.train.step import (TrainState, _select_pixels_crop, _select_pixels_full,
                                     create_train_state, make_train_scan_step,
                                     make_train_step, scene_arrays, step_randomness)

NET = dict(netdepth=3, netwidth=32, multires=4, multires_views=2)


def tiny_args(**kw):
    args = default_config(N_train=64, N_samples=8, N_importance=8, near=1.0, far=12.0,
                          perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05,
                          lrate=5e-3, lrate_decay=500, precision="f32", i_print=1000,
                          i_save=1000, i_test=0, seed=0, **NET)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_select_pixels_full_without_replacement():
    _, gen = step_randomness(1, 0, 3, "cpu")
    pix = _select_pixels_full(gen, 8, 10, 50, "cpu")
    assert pix.shape == (50,) and len(set(pix.tolist())) == 50
    assert 0 <= int(pix.min()) and int(pix.max()) < 80
    _, gen = step_randomness(1, 0, 3, "cpu")
    assert torch.equal(pix, _select_pixels_full(gen, 8, 10, 50, "cpu"))


@pytest.mark.parametrize("short", [False, True])
def test_select_pixels_crop_invariants(short):
    """Labeled picks last and from the image's labeled list (distinct when
    there are enough; with replacement when there are fewer than n_ins), the
    rest distinct, inside the crop, and never a labeled pick."""
    sc = make_scene_crop(H=16, W=16, n_train=2, n_test=1)
    if short:
        sc.ins_indices = [ix[:5] for ix in sc.ins_indices]
    arrs = scene_arrays(sc, "cpu")
    n_train, n_ins = 40, 12
    crop = set(np.where(sc.crop_mask.reshape(-1) == 1)[0].tolist())
    for img_i in range(2):
        _, gen = step_randomness(0, img_i, 2, "cpu")
        pix, lab = _select_pixels_crop(gen, arrs, img_i, n_train, n_ins, 256)
        labeled = set(sc.ins_indices[img_i].tolist())
        assert pix.shape == (n_train,) and torch.equal(pix[-n_ins:], lab)
        assert set(lab.tolist()) <= labeled
        assert len(set(lab.tolist())) == (min(5, n_ins) if short else n_ins)
        unlab = pix[:-n_ins].tolist()
        assert len(set(unlab)) == len(unlab) and set(unlab) <= crop
        assert not set(unlab) & set(lab.tolist())


def _jax_pair(args, cfg_t, seed=0):
    cfg_j = jf.FieldConfig.from_args(args)
    pj = {k: jf.init_field_params(jax.random.PRNGKey(seed + i), cfg_j)
          for i, k in enumerate(("coarse", "fine"))}
    pt = {}
    for k, v in pj.items():
        pt[k] = tf.DMNeRFField(cfg_t)
        pt[k].load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, v)))
    return cfg_j, pj, pt


def test_train_step_matches_jax_step():
    """One step from identical params on all 64 pixels of an 8x8 view (the
    port's sampler draws them in another order; every loss term is a mean or
    sum over rays), perturb off, penalizer on, f32, the fused field on both
    sides (Pallas interpret / the port's plain versions). The two differ by
    the order of f32 sums, which can move an importance sample by ~1e-6:
    loss and metrics within 1e-4 relative, gradients within 1e-3 relative L2
    per parameter, and the Adam update (lr 5e-3, about lr * sign(grad) on a
    first step) within 1e-6 on all but parameters whose gradient is below
    1e-7 in size."""
    scene = make_scene(H=8, W=8, n_train=1, n_test=1)
    args = tiny_args(perturb=0.0, pallas_train=True)
    args.ins_num = scene.ins_num
    cfg_t = tf.FieldConfig.from_args(args)
    cfg_j, pj, pt = _jax_pair(args, cfg_t)

    # JAX: render_rays + losses + optax.adam, as make_train_step composes them
    pix = jnp.arange(64)
    ro, rd = jax_rays_at_pixels(pix, 8, jnp.asarray(scene.K, jnp.float32),
                                jnp.asarray(scene.poses[0]))
    target_c = jnp.asarray(scene.images[0].reshape(-1, 3))
    target_i = jnp.asarray(scene.gt_labels[0].reshape(-1))
    field = jax_ptf(cfg_j)

    def loss_fn(params):
        out = jrend.render_rays(lambda p, v: field(params["coarse"], p, v),
                                lambda p, v: field(params["fine"], p, v), ro, rd,
                                jax_z_val_sample(64, 1.0, 12.0, 8), 8, key=None,
                                perturb=False)
        rgb_loss = jax_img2mse(out["rgb_fine"], target_c) + jax_img2mse(out["rgb_coarse"],
                                                                         target_c)
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

    opt, sched = make_optimizer(pt, args.lrate, args.lrate_decay)
    state = TrainState(pt, opt, sched, 0)
    step = make_train_step(args, cfg_t)
    _, gen = step_randomness(0, 0, 1, "cpu")
    old = {k: {n: p.detach().clone() for n, p in m.named_parameters()} for k, m in pt.items()}
    m = step(state, scene_arrays(scene, "cpu"), gen, 0)

    np.testing.assert_allclose(float(m["total_loss"]), float(jtotal), rtol=1e-4)
    for k in ("rgb_loss", "ins_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4)
    assert state.step == 1
    for key in ("coarse", "fine"):
        want_g = state_dict_from_jax(jax.tree.map(np.asarray, jgrads[key]))
        want_p = state_dict_from_jax(jax.tree.map(np.asarray, jnew[key]))
        for name, p in pt[key].named_parameters():
            g = p.grad
            err = (g - want_g[name]).norm() / want_g[name].norm().clamp_min(1e-30)
            assert err <= 1e-3, (key, name, float(err))
            live = want_g[name].abs() > 1e-7
            dp = (p.detach() - want_p[name]).abs()
            assert float(torch.where(live, dp, 0.0).max()) <= 1e-6, (key, name)
            assert not torch.equal(p.detach(), old[key][name]), (key, name)


def test_scan_steps_equal_single_steps():
    scene = make_scene(H=16, W=16, n_train=3, n_test=1)
    args = tiny_args()
    args.ins_num = scene.ins_num
    cfg = tf.FieldConfig.from_args(args)
    arrs, i_train = scene_arrays(scene, "cpu"), np.asarray(scene.i_train)
    scan = make_train_scan_step(args, cfg)
    s4, s1 = (create_train_state(0, cfg, args.lrate, args.lrate_decay) for _ in range(2))
    m4 = scan(s4, arrs, 7, i_train, 4)
    for _ in range(4):
        m1 = scan(s1, arrs, 7, i_train, 1)
    assert s4.step == s1.step == 4
    assert torch.equal(m4["total_loss"], m1["total_loss"])
    for a, b in zip(s4.opt.param_groups[0]["params"], s1.opt.param_groups[0]["params"]):
        assert torch.equal(a, b)


def test_resume_replays_bit_for_bit(tmp_path):
    """6 steps straight == 3 steps, a checkpoint, a fresh process state
    resumed from it, and 3 more: parameters and Adam state bit for bit."""
    scene = make_scene(H=16, W=16, n_train=3, n_test=1)

    def run(sub, n_iters, resume=False):
        args = tiny_args(basedir=str(tmp_path), expname=sub, log_time="run", i_save=3,
                         resume=resume)
        return train(args, scene, "cpu", n_iters=n_iters)

    a = run("straight", 6)
    run("split", 3)
    b = run("split", 6, resume=True)
    assert a.step == b.step == 6
    for key in ("coarse", "fine"):
        for (n, p), q in zip(a.params[key].named_parameters(), b.params[key].parameters()):
            assert torch.equal(p, q), (key, n)
    sa, sb = a.opt.state_dict(), b.opt.state_dict()
    for i in sa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    assert a.opt.param_groups[0]["lr"] == b.opt.param_groups[0]["lr"]
    assert sorted(os.listdir(tmp_path / "split" / "run")).count("000003.tar") == 1


def test_adam_step_from_carried_jax_state_matches_optax():
    """A JAX TrainState after one optax step, carried across by
    train_state_from_jax, takes a second step with the same gradients on
    both sides: the same Adam (bias correction, eps, lr of step 1) in f32,
    1e-7."""
    args = tiny_args()
    args.ins_num = 4
    cfg_t = tf.FieldConfig.from_args(args)
    _, pj, _ = _jax_pair(args, cfg_t, seed=3)
    rng = np.random.default_rng(0)
    g1, g2 = (jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), pj)
              for _ in range(2))
    tx = jax_make_optimizer(args.lrate, args.lrate_decay)
    s0 = tx.init(pj)
    u1, s1 = tx.update(g1, s0, pj)
    p1 = optax.apply_updates(pj, u1)
    u2, _ = tx.update(g2, s1, p1)
    p2 = optax.apply_updates(p1, u2)

    adam = s1[0]
    np_ = lambda t: jax.tree.map(np.asarray, t)
    fields, opt_sd = train_state_from_jax(np_(p1), np_(adam.mu), np_(adam.nu),
                                          int(adam.count), cfg_t, args.lrate,
                                          args.lrate_decay)
    opt, sched = make_optimizer(fields, args.lrate, args.lrate_decay, start_step=1)
    opt.load_state_dict(opt_sd)
    sched = ck.make_scheduler(opt, args.lrate, args.lrate_decay, 1)
    for key in ("coarse", "fine"):
        grads = state_dict_from_jax(np_(g2[key]))
        for name, p in fields[key].named_parameters():
            p.grad = grads[name].clone()
    opt.step()
    for key in ("coarse", "fine"):
        want = state_dict_from_jax(np_(p2[key]))
        for name, p in fields[key].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-7,
                                       rtol=0, err_msg=f"{key}.{name}")


def test_checkpoint_roundtrip(tmp_path):
    scene = make_scene(H=16, W=16, n_train=2, n_test=1)
    args = tiny_args()
    args.ins_num = scene.ins_num
    cfg = tf.FieldConfig.from_args(args)
    state = create_train_state(0, cfg, args.lrate, args.lrate_decay)
    make_train_scan_step(args, cfg)(state, scene_arrays(scene, "cpu"), 1,
                                    np.asarray(scene.i_train), 2)
    path = ck.save_checkpoint(str(tmp_path), state, 2)
    assert ck.latest_checkpoint(str(tmp_path)) == path and ck.checkpoint_step(path) == 2
    fresh = create_train_state(9, cfg, args.lrate, args.lrate_decay)
    ck.restore_checkpoint(path, fresh, args.lrate, args.lrate_decay)
    assert fresh.step == 2
    assert fresh.opt.param_groups[0]["lr"] == state.opt.param_groups[0]["lr"]
    for a, b in zip(state.opt.param_groups[0]["params"], fresh.opt.param_groups[0]["params"]):
        assert torch.equal(a, b)
    sa, sb = state.opt.state_dict()["state"], fresh.opt.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)
    blob = torch.load(path, weights_only=True)
    assert set(blob) == {"iteration", "network_coarse_state_dict",
                         "network_fine_state_dict", "optimizer_state_dict"}


def test_cli_train_then_render_on_cpu(tmp_path, capsys):
    """python -m dmnerf_torch.cli.train --device cpu trains with finite
    losses and writes a .tar that dmnerf_torch.cli.test --render renders."""
    from dmnerf_torch.cli.test import main as test_main
    from dmnerf_torch.cli.train import main as train_main

    cfg = tmp_path / "c.txt"
    cfg.write_text("\n".join([
        "expname = cli", f"basedir = {tmp_path / 'logs'}", "log_time = run",
        "datadir = ./data/synthetic/boxroom16x4", "N_train = 64", "N_samples = 8",
        "N_importance = 8", "N_test = 64", "near = 1.0", "far = 12.0", "penalize",
        "tolerance = 0.05", "deta_w = 0.05", "n_iters = 5", "i_print = 2", "i_save = 4",
        "i_test = 4", "eval_views = 1"] + [f"{k} = {v}" for k, v in NET.items()]) + "\n")
    state = train_main(["--config", str(cfg), "--device", "cpu"])
    assert state.step == 6
    ldir = tmp_path / "logs" / "cli" / "run"
    lines = [json.loads(l) for l in open(ldir / "metrics.jsonl")]
    assert [l["step"] for l in lines] == [2, 4, 6]
    assert all(np.isfinite(l[k]) for l in lines for k in ("total_loss", "psnr_fine"))
    assert {"000004.tar", "000006.tar", "testset_000004"} <= set(os.listdir(ldir))
    assert "[TRAIN] Iter: 6" in capsys.readouterr().out
    savedir = test_main(["--config", str(cfg), "--render", "--device", "cpu"])
    assert savedir.endswith("render_test_000006")
    assert np.isfinite(np.loadtxt(os.path.join(savedir, "test_results.txt"))[:, 0]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_main(["--config", str(cfg)])
