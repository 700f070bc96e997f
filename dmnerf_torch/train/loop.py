"""Training loop (port of dmnerf_tpu/train/loop.py; reference
train_dmsr.py:17-107).

- steps run in groups of k (make_train_scan_step), k the largest divisor of
  the print/save/eval cadences <= 100 unless --scan_steps sets it; the
  cadences fire on crossing each multiple;
- every step's randomness derives from (seed, step), so a killed and
  resumed run replays the uninterrupted one;
- `{log_dir}/NNNNNN.tar` every i_save and at the end, and --resume from the
  latest one (the checkpoint of N completed steps; nothing re-runs);
- an in-training eval of args.eval_views test views every i_test, through
  the eval renderer and tester;
- `metrics.jsonl` with rays/s per print window;
- --profile_steps N: a torch.profiler trace of N dispatches after the first
  (which holds the kernels' builds and the cuBLAS/cuDNN set-up) into
  {log_dir}/profile (utils/profiling.trace).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from math import gcd

import numpy as np
import torch

from dmnerf_torch.models.fields import FieldConfig
from dmnerf_torch.train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                           save_checkpoint)
from dmnerf_torch.train.step import (create_train_state, make_train_scan_step,
                                     scene_arrays)
from dmnerf_torch.config import log_dir
from dmnerf_torch.utils.profiling import trace


def _scan_stride(args, eval_every: int) -> int:
    """Largest divisor of the print/save/eval cadences <= 100."""
    g = gcd(int(args.i_print), int(args.i_save))
    if eval_every:
        g = gcd(g, int(eval_every))
    g = max(1, g)
    return next(d for d in range(min(g, 100), 0, -1) if g % d == 0)


def train(args, scene, device, n_iters=None):
    """Run training on `device` for n_iters steps (default: the reference's
    args.n_iters + 1). Returns the final TrainState."""
    device = torch.device(device)
    args.ins_num = scene.ins_num
    cfg = FieldConfig.from_args(args)
    sampler = "crop" if scene.ins_indices is not None else "full"
    ldir = log_dir(args)
    os.makedirs(ldir, exist_ok=True)

    state = create_train_state(args.seed, cfg, args.lrate, args.lrate_decay,
                               getattr(args, "init_scheme", "he"), device)
    if getattr(args, "resume", False):
        ckpt = latest_checkpoint(ldir)
        if ckpt:
            restore_checkpoint(ckpt, state, args.lrate, args.lrate_decay)
            print(f"resumed from {ckpt} @ step {state.step}")

    n_iters = n_iters if n_iters is not None else int(getattr(args, "n_iters", 500000)) + 1
    eval_every = args.i_test
    k = int(getattr(args, "scan_steps", 0) or 0) or _scan_stride(args, eval_every)
    step_k = make_train_scan_step(args, cfg, sampler=sampler)
    arrs = scene_arrays(scene, device)
    i_train = np.asarray(scene.i_train)
    base_seed = args.seed + 1
    profile_steps = int(getattr(args, "profile_steps", 0) or 0)
    profile_dir = os.path.join(ldir, "profile")
    dispatch_i = 0

    render_im = None          # built at the first eval, reused after
    t_window = time.time()
    rays_done = 0
    done = state.step
    profiling = contextlib.ExitStack()
    while done < n_iters:
        if profile_steps and dispatch_i == 1:
            # dispatch 0 is left out: it holds the kernels' builds
            profiling.enter_context(trace(profile_dir, device))
        ran = min(k, n_iters - done)
        metrics = step_k(state, arrs, base_seed, i_train, ran)
        done += ran
        dispatch_i += 1
        if profile_steps and dispatch_i > 1 and (dispatch_i > profile_steps
                                                 or done >= n_iters):
            profiling.close()             # synchronises the device, then stops
            print(f"profiler trace written to {profile_dir}")
            profile_steps = 0
        rays_done += args.N_train * ran
        prev = done - ran

        def crossed(every):
            return every and (done // every) > (prev // every)

        if crossed(args.i_print) or done == n_iters:
            # one device->host copy for all the scalars
            m = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
            dt = time.time() - t_window
            rps = rays_done / dt if dt > 0 else 0.0
            print(f"[TRAIN] Iter: {done} PSNR: {m['psnr_fine']:.4f} "
                  f"Total_Loss: {m['total_loss']:.5f} RGB_Loss: {m['rgb_loss']:.5f} "
                  f"Ins_Loss: {m['ins_loss']:.5f} rays/s: {rps:,.0f}")
            with open(os.path.join(ldir, "metrics.jsonl"), "a") as f:
                json.dump({"step": done, "rays_per_sec": round(rps, 1),
                           **{k_: round(v, 6) for k_, v in m.items()}}, f)
                f.write("\n")
            t_window = time.time()
            rays_done = 0

        # the final state is saved too when n_iters is not a multiple of i_save
        if crossed(args.i_save) or done == n_iters:
            save_checkpoint(ldir, state, done)

        if crossed(eval_every) and done < n_iters:
            if render_im is None:
                from dmnerf_torch.eval.renderer import make_image_renderer
                render_im = make_image_renderer(cfg, args, scene.H, scene.W, device=device,
                                                use_pallas=getattr(args, "use_pallas", True))
            _in_train_eval(args, render_im, state, scene, ldir, done)
            t_window = time.time()
            rays_done = 0

    return state


def _in_train_eval(args, render_im, state, scene, ldir, step):
    """args.eval_views random test views (default 10, train_dmsr.py:88-107),
    chosen as a pure function of (seed, step); eval_views >= the split size
    evaluates all test views in order."""
    from dmnerf_torch.eval.tester import render_test

    n_views = int(getattr(args, "eval_views", 10) or 10)
    if n_views >= len(scene.i_test):
        sel = scene.i_test
    else:
        rng = np.random.default_rng([args.seed, step])
        sel = scene.i_test[rng.choice(len(scene.i_test), size=n_views, replace=False)]
    savedir = os.path.join(ldir, f"testset_{step:06d}")
    os.makedirs(savedir, exist_ok=True)
    render_test(render_im, state.params, scene.poses[sel], scene.hwk, args,
                gt_imgs=scene.images[sel], gt_labels=scene.gt_labels[sel],
                ins_rgbs=scene.ins_rgbs, savedir=savedir, crop_mask=scene.crop_mask)
