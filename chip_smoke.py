"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a): the render
path (kernels K3/K4), the training step (kernels K1/K2), the edit path
(kernels K1/K5) and mesh extraction (kernels K1, K4/K3), each in bf16 and,
through the kernels' f32 builds, in f32; then the reference-format stress
scenes written, read and run through the CLIs, ScanNet (JPEG frames, the
.sens preprocessing, the flagship config) through them, LPIPS and the
profiler trace of the train step, the ray mesh (torchrun over NCCL;
two ranks on the card over gloo) and the 2-D (data, model) mesh (four gloo
ranks on the card running dmnerf_torch.graft_entry.dryrun_multichip).

    python3 chip_smoke.py

Phases (each fails the run by raising; nothing is caught):
1. the card: CUDA must be available; prints nvidia-smi's name and power limit.
2. build: compiles dmnerf_torch/kernels/csrc/{render_field,field}.cu with one
   nvcc each, started together, into build/kernels/ and prints the seconds
   and the compiler's register report.
3. kernels vs their plain PyTorch versions at the flagship field (8x256,
   PE 10/4, K=32, bf16) on 4096 rays: K4 (render_field_sigma) at S=64, K3
   (render_field_all) at S=192 on the z-union that the coarse pass and
   sample_pdf produce; max abs error per output against its tolerance, K3
   against core/rendering.composite of K1's raw (K1 and K3 run the same tile
   forward) within COMPOSITE_TOL, and the median time of each (CUDA events).
   3b: K3 and K5 the same way at K=64 (CP 80).
4. the slice through its entry point: dmnerf_torch.cli.test --render on the
   synthetic scene boxroom128x8 (128x128, 2 test views) with a He-initialised
   flagship pair saved as 000001.tar; test_results.txt must hold finite PSNR
   and both kernels must have launched once per 4096-ray chunk per view. Then
   a 32x32 render through the kernels is held against the plain unfused path.
6. K1 (field_forward) and K2 (field_backward) vs their plain versions at the
   flagship field (K=32, bf16) on the train step's shapes, 3072 rays x 64
   (coarse) and x 192 (fine) points: the error of raw per column (and that
   the check rejects raw with the rgb bias off by 10%), relative L2 error of
   every parameter's gradient, K2 bit-identical across two launches, an
   instance-logit loss giving the trunk exactly zero gradient, and the median
   time of each kernel and its plain version (K1; K2); the same checks and
   times at K=64 on the coarse shape.
7. the training slice through its entry point: dmnerf_torch.cli.train on
   boxroom128x8 at flagship width (N_train 3072, 64+128 samples, penalizer,
   bf16) for 30 steps with one in-train eval; every printed loss finite, K1
   and K2 launched twice per step each, the final NNNNNN.tar rendered by
   dmnerf_torch.cli.test --render, and two 3-step runs from one seed ending
   with bit-identical parameters. 7b: the field that phases 12 and 13 mesh,
   cli.train on boxroom128x8 at flagship width for MESH_STEPS steps (2 K1
   and 2 K2 launches each).
9. K5 (render_field_ins) vs its plain version at the flagship field (K=32) on
   phase 3's 4096 rays x 192 samples, the z-union of an accumulated-label
   pass (the det linspace and 128 det sample_pdf samples): per-ray max error
   of the logits, the logits equal to K3's bit for bit, and the median times
   of K5, its plain version and K3 at that shape.
10. the edit slice through its entry points, dmnerf_torch.edit.runner's
   manipulator_eval (boxroom128x8's test views, a rigid translation of label
   1) and manipulator_demo (a rigid translation and a 'sin' deform, 2 views),
   flagship width, K=4, N_test 4096: every artifact written, finite PSNR,
   and per 4096-ray chunk 2 * (1 + n_obj) launches of K1, 1 + n_obj of K5
   and none of K3/K4. Then a 32x32 edit through the kernels is held against
   the plain path (use_pallas False), and the same bars must reject two
   broken edits (the move label off by one; the second exchange skipped).
12. the f32 builds (precision f32; their products three TF32 passes on the
   tensor cores) at the flagship field, K=32: K4, K3 and K5 on phase 3's
   rays against their plain f32 versions (F32_TOL) with their median times;
   K1/K2 at the train step's coarse and fine shapes, 3072 rays x 64 and x
   192 (589,824 points), against their plain f32 versions (F32_TOL; K2
   bit-identical across launches), the peak device memory of K2's f32
   build, and their median times at both shapes; one f32 render view and
   one f32 edit view (128x128, one rigid object) on the kernels and on the
   plain path (use_pallas False), every f32 composite launch held to its
   plain version on its inputs (composites_held) and the kernels' view held
   to the plain one (VIEW_OFF); then through the entry points, with the
   same holding: dmnerf_torch.cli.train for 3 steps, dmnerf_torch.cli.test
   --render of its .tar and a manipulator_eval, each launching only f32
   builds, as many as the bf16 runs launch bf16 ones; and
   dmnerf_torch.cli.test --mesh of phase 7b's field in f32 at grid 64,
   launching only the f32 builds of K1, K4 and K3.
13. the mesh slice through its entry point: dmnerf_torch.cli.test --mesh of
   phase 7b's field at the default grid 256, extents 12,12,12 (the verify
   skill's): both PLY files, a non-empty mesh, at least 2 labels,
   ceil(256^3 / DENSITY_BATCH) launches of K1, ceil(V / N_test) of K4 and of
   K3, none of K2 or K5; the seconds of every stage (scene, checkpoint,
   grid, host->device, density and K1's share of it by CUDA events,
   marching cubes native or numpy, cleanup, normals and vertex rays, labels,
   PLY writes), V and F. Then the labels of the first N_test vertex rays
   against the plain unfused route (98%, phase 4b's bar) and a 589,824-point
   slice of the grid through K1 against the plain forward (RAW_COL_TOL,
   RAW_L2_TOL).
14. reference-format scenes: dmnerf_torch.tools.make_stress_scenes writes
   the DM-SR stress scene (640x480, 48 train + 4 test views and 4 edited,
   16 objects) and replica64 (360 frames at 120x160, 64 objects) on the
   card at the tool's full sizes (the seconds of the GT renders, and the
   rest: the PNG writes with the JSON, pose and HDF5 files); load_dataset
   reads both (seconds), with none of imageio, h5py, cv2 or PIL in
   sys.modules; then through the CLIs, datadir and basedir overridden:
   dmnerf_torch.cli.train for STRESS_STEPS steps of
   configs/stress/dmsr_stress.txt (8x256, K=17, 2048 rays, 64+128; ms/step
   after the first 10), cli.test --render (4 views), --mani_eval (4 views),
   --mani_demo rigid and deform (mixed, 2 objects) at --views 2 (s/view of
   each: the whole CLI call over its views), --mesh at 192^3 (V, F,
   seconds; an empty mesh fails), then STRESS_STEPS steps of
   replica64_stress.txt (8x128, K=65) and its --render (23 views). After
   each training run, the trained field at the config's shapes: K1 and K2
   on one training batch (2048 rays x 64 and x the fine z-union, 192 or
   128), K4 and K3 on the middle 4096-ray chunk of a test view (x 64, x the
   fine z-union), and on DM-SR K5 on that chunk (what an edit's
   accumulated-label pass composites), each against its plain version at
   phases 3, 6 and 9's bars (stress_kernels_vs_plain). Each CLI run
   with exact launch counts (2 K1 and 2 K2 per step; ceil(H*W / 4096) K4
   and K3 per rendered view, and 3 views' worth for resolve_target_label;
   per edit chunk 2(1+n_obj) K1 and 1+n_obj K5; ceil(192^3 / 2^21) K1 and
   ceil(V / 4096) K4 and K3 per mesh), and each test_results.txt's PSNR and
   AP50 (evidence that the path runs, not a quality bar).
15. ScanNet: (a) dmnerf_torch/native/jpeg.cpp built by g++; every fixture
   of tests/torch_golden/jpeg decoded to the array Pillow decoded (sha256)
   and every imageio-default fixture's source encoded to its bytes
   (jpeg_golden); ms per 968x1296 decode and encode. (b) make_stress_scenes
   --only scannet on the card (480x640, 20 + 3 views, 16 objects),
   load_dataset with no banned module loaded, cli.train of
   configs/stress/scannet_stress.txt (8x128, 2048 rays, 64+64, 576x432
   crop) for STRESS_STEPS steps, K1/K2/K4/K3 against their plain versions
   on the trained field (stress_kernels_vs_plain), cli.test --render of
   its 3 test views. (c) a raw ScanNet scene written by write_raw_scannet
   (a version-4 .sens of SENS_FRAMES 1296x968 JPEG frames from the card's
   GT march, 640x480 zlib depth and depth intrinsics, label-filt and
   instance-filt PNGs, a label-map TSV) through `python -m
   dmnerf_torch.data.scannet_preprocess.run` (seconds of the export per
   frame, the label remap and the split), load_dataset with resize (ms per
   frame), cli.train of configs/scannet/train/scene0010_00.txt (8x256,
   N_train 3072, 64+128, resize, 640x480 crop) for SCANNET_STEPS steps
   (ms/step after the first 10), K1/K2/K4/K3 against their plain versions
   on that trained field at its shapes (3072 rays x 64 and x 192, 4096-ray
   chunks of 480x640, width 256, its ins_num) as in (b), and cli.test
   --render of configs/scannet/test/scene0010_00.txt on every 8th test view
   (s/view). Exact launch counts throughout.
16. LPIPS and the trace: (a) eval/lpips.py with random weights in the .npz
   layout (LPIPS_SEED) on the card against the CPU on a 480x640 pair and its
   432x576 crop, normalize False and True, within LPIPS_TOL of max(1,
   |CPU|), with the TF32-on difference beside it (a finding only), ms per
   call (median of 5) and the fp32 bound; (b) cli.test --render and
   --mani_eval with --lpips_weights on phase 14's trained dmsr_stress field
   (4 views each): a finite LPIPS column and mean, s/view against phase
   14's calls without LPIPS, exact launches; (c) cli.train --profile_steps
   PROFILE_STEPS --scan_steps PROFILE_SCAN for PROFILE_ITERS steps at
   flagship width (3072 rays, 64+128 samples, on PROFILE_SCENE) and the
   same run untraced: metrics.jsonl equal but for
   rays_per_sec, and `python -m dmnerf_torch.tools.trace_step --parse_only`
   on its trace, which must hold device events and exactly 2 launches of
   K1 and of K2 per traced step; (d) `python -m
   dmnerf_torch.tools.trace_step` capturing bench.py's train workload
   (trace_step.bench_workload, CAPTURE_STEPS steps): device time by
   category, the top kernels, the device's busy share and the host's time
   in launches, copies and waits, torch ops and Python, with the LAP's
   spans.
17. the ray mesh (dmnerf_torch/parallel/mesh.py): (a) `python -m
   torch.distributed.run --nproc_per_node 1` of cli.train (phase 7's 30
   flagship steps with an in-train eval at 15) and of cli.test --render,
   each rank running this file with `--rank cli` so that it can report its
   launches, over NCCL at world size 1: the weights and Adam state, the
   metrics, the eval's and the render's files equal to the same runs in this
   process bit for bit, and the launches equal. (b) two ranks of this file
   (`--rank mesh`) on cuda:0, their collectives over gloo, while this process
   runs the same work alone (mesh_work): RANK_STEPS steps of bench.py's
   train workload (trace_step.bench_workload: 3072 rays, 64+128, K=32,
   penalizer and perturb on), then a 128x128 render and a 1-object edit of
   a fresh pair; the first step's
   raws equal to one rank's rows bit for bit, its gradients within GRAD_TOL
   relative L2 per parameter, the ranks' parameters, gradients and metrics
   bit-identical, the render bit for bit and the edit within phase 10b's
   bars; exact launches per rank (2 K1 and 2 K2 per step, 4 K4 and 4 K3 per
   render, 16 K1 and 8 K5 per edit), and the phase's seconds.
18. the 2-D (data, model) mesh (parallel/mesh.py::make_mesh_2d,
   parallel/model_parallel.py): bench.py's train workload
   (trace_step.bench_workload) is made once here and handed to the ranks;
   (a) `torch.distributed.run --nproc_per_node 1` of this file (`--rank
   grid1`) at make_mesh_2d(1, 1) over NCCL: one bf16 step on each
   pallas_train path, gradients, parameters and metrics equal
   to the same step in this process bit for bit; (b) four ranks of this
   file (`--rank grid4`) under torchrun on cuda:0, their collectives over
   gloo, run dmnerf_torch.graft_entry.dryrun_multichip(4) on a (2, 2) mesh
   (the flagship model in f32: 8 scanned steps on K1/K2, a render on K4/K3
   and a two-object edit on K1/K5 equal to one rank, 1e-5, labels exact),
   then (c) one bf16 step of the bench workload on each pallas_train path:
   the gradients, gathered whole, within GRAD_TOL relative L2 of this
   process's one-rank step, every rank's gathered gradients bit-identical,
   each rank's parameter and Adam bytes (the split leaves at 1/2, the heads
   whole), exact launches per rank; and graft_entry.entry() in this process
   (the flagship forward of 1024 rays on K1). Prints the phase's seconds.
Phases 3, 3b, 6, 9 and 12 also print each kernel's bound (the larger of its
operations over the peak of its type and its bytes over the memory rate:
bf16 tensor cores; for the f32 builds three TF32 passes at the TF32 rate,
with the fp32 CUDA-core bound beside it; the operations as
benchmark/counts.py counts them), its TFLOP/s and its share of the bound.
There is no phase 5, 6b, 6c, 8 or 11: the benchmark (benchmark/run.py)
times the render view, the train step and the edit view at published
shapes, and the kernels are timed here alone. `python3 chip_smoke.py --ab
DIR ...` times this tree's kernels against another tree's sources in one
process instead (ab_main).
The line before the last is a JSON object with one entry per kernel and
build (its K=64 reading under "k64", its phase-14 and phase-15 errors per
config under "stress_max_abs_err"; launches summed over the main paths,
phases 14, 15, 16, 17 and 18's sharded runs included); the line before it is the smoke's total time; the
last line is {"ok": true, "device": {...}}. The run fails if it loaded jax,
the JAX package, imageio, h5py, cv2 or PIL.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import counts

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = "dmnerf_torch/kernels/csrc/render_field.cu"
REPLACES = "dmnerf_tpu/ops/pallas/render_field.py:118"
FIELD_SRC = "dmnerf_torch/kernels/csrc/field.cu"
K1_REPLACES = "dmnerf_tpu/ops/pallas/field_kernels.py:320"
K2_REPLACES = "dmnerf_tpu/ops/pallas/field_kernels.py:345"
FLAGSHIP = dict(netdepth=8, netwidth=256, multires=10, multires_views=4)
SYNTHETIC_INS_NUM = 4     # the synthetic boxroom scene's object slots

# kernel vs plain version, bf16 operands and fp32 accumulation on both sides:
# only the summation order differs, which can flip a stored bf16 activation by
# one ulp (2^-8 relative). A CPU run at this width with fp64 accumulation in
# place of fp32 moved weights by 1e-3, rgb by 1e-4, ins logits by 8e-4.
TOL = {"weights": 1e-2, "rgb": 5e-3, "depth": 5e-2, "ins_logits": 2e-2}
# The last sample's distance is 1e10, so its alpha is a step in sign(sigma):
# where the plain version's sigma there is within SIGMA_STEP of 0, the two
# may land on either side and that ray's outputs jump (by up to its
# remaining transmittance). Such rays are exempt, and may be at most
# MAX_STEP_RAYS of them.
SIGMA_STEP = 0.05
MAX_STEP_RAYS = 8
# K1 vs its plain version, per point (no compositing averages the raw): the
# same one-ulp bf16 flips of an activation, carried by the later layers, so
# most values agree exactly and a few points move. Each of the 4+K+1 columns
# is held on its own: its max error within RAW_COL_TOL of its max |raw|, and
# its relative L2 error within RAW_L2_TOL, so a fault in the small rgb
# columns cannot hide under the largest logits. On an NVIDIA H100 (700 W) at
# the flagship K=32 on 196,608 and 589,824 points the worst column measured
# 1.3e-2 and 1.5e-2 of its scale and 1.7e-3 relative L2; an rgb bias off by
# 10% measured 1.0e-2 relative L2, and the check must reject it.
RAW_COL_TOL = 3e-2
RAW_L2_TOL = 5e-3
# K3 vs core/rendering.composite of K1's raw: K1 and K3 run the same tile
# forward, so their raw agrees to the last bit and only the fp32 rounding of
# the scan (the kernel's sequential sums and expf against torch's cumprod,
# sums and exp) differs. Max abs error over max(1, max |output|): an NVIDIA
# H100 (700 W) measured at most 1.1e-6 at K=32 and K=64 on 4096 x 192; a
# one-ulp bf16 flip in the raw (what a different field would give) moves it
# by ~1e-3.
COMPOSITE_TOL = 2e-5
# An edit through the kernels vs the plain path (use_pallas False), per
# pixel: a one-ulp bf16 flip can move a point's instance argmax and with it an
# exchange decision, so single pixels may differ by a lot while the image
# agrees. Held: the mean abs rgb error within EDIT_MEAN_TOL, and the share of
# pixels whose rgb moves by more than EDIT_RGB_STEP (any channel) or whose
# label differs within EDIT_FRAC_TOL. Both bars must also reject a broken
# edit (phase 10). On an NVIDIA H100 (700 W) at 32x32 the kernel edit
# measured 3.9e-4 and 3.0% (2.6% relabelled) against the plain edit, and
# 1.09e-2 / 39% and more against the unedited image and the broken edits:
# each bar sits about midway between, on a log scale.
EDIT_RGB_STEP = 2e-2
EDIT_MEAN_TOL = 2e-3
EDIT_FRAC_TOL = 1e-1
# K2 vs its plain version, relative L2 error per parameter's gradient. The
# flips above cascade through the layers (ReLU masks included), so the
# gradient moves with the order of fp32 summation: the plain version run
# with f64 in place of f32 accumulation differs from itself by 1.1e-2 at the
# flagship width (CPU, 3700 points); an NVIDIA H100 (700 W) measured 1.2e-2-1.7e-2.
GRAD_TOL = 3e-2
# The f32 builds vs their plain f32 versions: activations, gradients and sums
# stay fp32 on both sides, but the kernels' products are three TF32 passes
# (hi_a hi_b + hi_a lo_b + lo_a hi_b of operands split in two 11-bit
# halves), which the plain path computes in full fp32. The split and the
# order of the fp32 sums differ: on the CPU the emulated split moves the
# flagship raw by 8.9e-7 of scale and its gradients by 1.6e-6 relative L2,
# one TF32 pass by 1.1e-3 and 6.2e-2 (tests/test_torch_f32_split.py). K2's
# forward recompute sums in order of k on the CUDA cores, as the plain GEMM
# does, so that the gradients see the plain path's ReLU masks. Raw
# and render outputs within F32_TOL of max(1, the largest magnitude of the
# plain output), gradients within F32_TOL relative L2; rays whose plain
# last-sample |sigma| < F32_STEP sit on the last-sample step and are exempt.
F32_TOL = 1e-4
F32_STEP = 1e-3
# phase 12's f32 views, kernels against the plain path. Every launch of an
# f32 composite is held to its plain version on its own inputs
# (composites_held); the views themselves differ where a ray's importance
# samples cross a bin of the coarse CDF (a step in the coarse weights) or an
# edit's decision sits on a tie: on an NVIDIA H100 (700 W) 212 of the 16,384
# pixels of the bench render view missed F32_TOL, by at most 1.0e-2, and 2
# changed their label. Held: at most VIEW_OFF of the pixels off F32_TOL or
# relabelled, and the median error within F32_TOL / 10.
VIEW_OFF = 0.05
F32_COMPOSITES = {"render_field_sigma": ("weights",),
                  "render_field_all": ("rgb", "depth", "ins_logits"),
                  "render_field_ins": ("ins_logits",)}


@contextlib.contextmanager
def composites_held(worst):
    """Inside the block every launch of an f32 composite (K4, K3, K5 f32) is
    held to its plain version on the same inputs (held_f32, quietly: rays on
    the last-sample step exempt); worst collects each kernel's largest error
    over max(1, max |plain|)."""
    from dmnerf_torch.kernels import render_field as krf
    real = {name: getattr(krf, name) for name in F32_COMPOSITES}

    def held(name):
        def call(params, pts, *rest):
            got = real[name](params, pts, *rest)
            field = krf._as_field(params)
            if pts.is_cuda and field.cfg.compute_dtype == torch.float32:
                with torch.no_grad():
                    want = getattr(krf, f"{name}_ref")(field, pts, *rest)
                    sig = field.density(pts[:, -1])[..., 0]
                outs, wants = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
                for out, a, b in zip(F32_COMPOSITES[name], outs, wants):
                    err = held_f32(f"{name}_f32 {out}", a, b, sig, quiet=True)
                    worst[name] = max(worst.get(name, 0.0),
                                      err / max(1.0, float(b.abs().max())))
            return got
        return call

    for name in F32_COMPOSITES:
        setattr(krf, name, held(name))
    try:
        yield worst
    finally:
        for name, fn in real.items():
            setattr(krf, name, fn)
# Published dense peaks of an H100 SXM at 700 W (NVIDIA's data sheet): the
# least time a kernel could take is the larger of its operations over the
# rate of their type and its bytes (each input read once, each output
# written once) over the memory rate (counts.PEAK_BYTES). bf16 builds: the
# bf16 tensor-core rate (counts.PEAK_BF16_FLOPS). f32 builds: fp32-accurate
# products on this card are three TF32 passes on the tensor cores (3 x
# operations at the TF32 rate), a tighter bound than the fp32 CUDA-core
# rate, which is printed beside it.
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
# steps of phase 7b's training: enough for boxroom128x8's walls and boxes to
# reach the mesh's iso level 0.45, sigma > -ln(0.55) * 128 / 11 = 6.96 at
# N_importance 128 and near/far 1/12. On an NVIDIA H100 (700 W) the 400-step
# field gave 1,819,582 faces at 256^3 (sigma up to ~10).
MESH_STEPS = 400
# the render kernels' f32 launch counts, in a run that launches only bf16 ones
F32_NONE = {"render_field_sigma_f32": 0, "render_field_all_f32": 0, "render_field_ins_f32": 0}


def check(name, out, got, want, sigma_last):
    """Max abs error over the rays held to TOL[out]; raises on a ray outside
    it that is not at the last-sample step, or on too many step rays."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} {out}: shape {tuple(got.shape)} or non-finite")
    err = (got - want).abs().reshape(got.shape[0], -1).amax(1)
    step = sigma_last.abs() < SIGMA_STEP
    off = err > TOL[out]
    held = float(err[~step].max())
    print(f"{name} {out} {tuple(got.shape)}: max abs err {held:.3e} "
          f"(median {float((got - want).abs().median()):.3e}, tolerance {TOL[out]:.0e}); "
          f"{int(off.sum())} rays outside it, all at the last-sample sigma step "
          f"(raw max {float(err.max()):.3e})")
    if bool((off & ~step).any()) or int(off.sum()) > MAX_STEP_RAYS:
        raise AssertionError(f"{name} {out}: {int((off & ~step).sum())} rays off "
                             f"tolerance away from the step, {int(off.sum())} in all")
    return held


def field_macs(cfg, part):
    """Multiply-adds per point of the work a kernel does, as the benchmark
    counts it (benchmark/counts.py) for a FieldConfig: "sigma" (K4: trunk
    and density), "ins" (K5: those and the instance branch, as
    k5_roofline.edit counts it), "all" (K1, K3: the whole field) or
    "backward" (K2: the activation gradients and one product per weight for
    dW, not the forward that K2 recomputes)."""
    c = vars(cfg)
    if part == "ins":
        d = counts.field_dims(c)
        return counts.trunk_macs(c) + d["W"] * d["W"] + d["W"] * d["HW"] + d["HW"] * d["K1"]
    return {"sigma": counts.trunk_macs, "all": counts.forward_macs,
            "backward": counts.backward_macs}[part](c)


def roofline(entry, macs, nbytes):
    """Adds the bound (ms, and whether operations or bytes set it;
    counts.least_time_s), the achieved TFLOP/s and the library yardstick
    (none) to a kernels entry."""
    secs, by = counts.least_time_s(2.0 * macs, nbytes)
    entry.update(bound_ms=secs * 1e3, bound_by=by,
                 tflops=2.0 * macs / (entry["ms"] * 1e-3) / 1e12, library_ms=None)
    print(f"{entry['name']}: bound {entry['bound_ms']:.3f} ms ({entry['bound_by']}; "
          f"{2.0 * macs / 1e12:.4f} TFLOP, {nbytes / 1e6:.1f} MB), {entry['tflops']:.1f} "
          f"TFLOP/s, {100 * entry['bound_ms'] / entry['ms']:.1f}% of the bound; no single "
          "PyTorch call computes it")
    return entry


def roofline_f32(entry, macs, nbytes):
    """roofline for an f32 build: its bound is that of three TF32 passes
    (bound_ms: 3 x its operations at the TF32 rate, or its bytes); the fp32
    CUDA-core bound of the FFMA design (ffma_bound_ms) stands beside it, so
    that a share above 100% of it reads as the tensor cores' work."""
    flop = 2.0 * macs
    t_ops, t_bytes = 3 * flop / PEAK_TF32_FLOPS * 1e3, nbytes / counts.PEAK_BYTES * 1e3
    t_ffma = max(flop / PEAK_FP32_FLOPS * 1e3, t_bytes)
    entry.update(bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 ffma_bound_ms=t_ffma, tflops=flop / (entry["ms"] * 1e-3) / 1e12,
                 library_ms=None)
    print(f"{entry['name']}: {entry['tflops']:.1f} TFLOP/s of fp32-accurate products "
          f"({flop / 1e12:.4f} TFLOP, {nbytes / 1e6:.1f} MB); 3xTF32 bound "
          f"{entry['bound_ms']:.3f} ms ({entry['bound_by']}; 3 x the operations at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s), {100 * entry['bound_ms'] / entry['ms']:.1f}% "
          f"of it; fp32 FFMA bound {t_ffma:.3f} ms ({PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s), "
          f"{100 * t_ffma / entry['ms']:.1f}% of it; no single PyTorch call computes it")
    return entry


def weight_bytes(packed):
    return packed.w.numel() * packed.w.element_size() + packed.b.numel() * 4


def render_bytes(name, R, S, packed, ins_num):
    """Bytes a render kernel must move: points, z and dists per sample (+ view
    directions per ray for K3) and the weights in; weights per sample (K4),
    rgb, depth and logits per ray (K3) or logits per ray (K5) out."""
    out = {"render_field_sigma": S, "render_field_all": 3 + 1 + ins_num + 1,
           "render_field_ins": ins_num + 1}[name]
    return (R * S * (12 + 4 + 4) + (R * 12 if name == "render_field_all" else 0)
            + weight_bytes(packed) + R * out * 4)


def against_k1_composite(name, k3_out, packed, pts, vd, z, rd):
    """K3's (rgb, depth, ins_logits) vs core/rendering.composite of K1's raw
    for the same points, within COMPOSITE_TOL of each output's scale."""
    from dmnerf_torch.core.rendering import composite
    from dmnerf_torch.kernels import field as kf
    comp = composite(kf.field_forward(packed, pts, vd), z, rd, keep_air=True)
    for out, got, want in zip(("rgb", "depth", "ins_logits"), k3_out,
                              (comp.rgb, comp.depth, comp.ins_logits)):
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        print(f"{name} {out} vs composite(field_forward(...)): max abs err {err:.3e}, "
              f"{err / scale:.3e} of max(1, max |{out}|) (tolerance {COMPOSITE_TOL:.0e})")
        if err > COMPOSITE_TOL * scale:
            raise AssertionError(f"{name} {out} is not the composite of K1's raw")


def wide_render_kernels(dev, card, ro, rd, vd, z):
    """Phase 3b: K3 and K5 at K=64 (CP 80) on phase 3's
    rays and fine z-union, against their plain versions and K1's composite;
    K5's logits equal K3's. Returns {name: its K=64 reading for the kernels
    line}."""
    from dmnerf_torch.kernels import render_field as krf
    from dmnerf_torch.models.fields import FieldConfig, init_field_params

    phase("3b K3/K5 vs plain versions at K=64 (flagship 8x256, bf16, 4096 rays x 192)")
    cfg = FieldConfig(**FLAGSHIP, ins_num=64)
    field = init_field_params(torch.Generator().manual_seed(64), cfg, device=dev).eval()
    packed = krf.pack_field(field)
    R, S = z.shape
    pts = ro[:, None] + rd[:, None] * z[:, :, None]
    out = {}
    with torch.no_grad():
        k3, k5 = krf.render_field_all(packed, pts, vd, z, rd), krf.render_field_ins(packed, pts, z, rd)
        p3, p5 = krf.render_field_all_ref(field, pts, vd, z, rd), krf.render_field_ins_ref(field, pts, z, rd)
        torch.cuda.synchronize()
        sig_last = field.density(pts[:, -1])[..., 0]
        worst = {"render_field_all": max(check("render_field_all K=64", o, g, w, sig_last)
                                         for o, g, w in zip(("rgb", "depth", "ins_logits"), k3, p3)),
                 "render_field_ins": check("render_field_ins K=64", "ins_logits", k5, p5, sig_last)}
        if not torch.equal(k5, k3[2]):
            raise AssertionError("K5's logits differ from K3's at K=64")
        print("render_field_ins K=64: logits equal to render_field_all's bit for bit")
        against_k1_composite("render_field_all K=64", k3, packed, pts, vd, z, rd)
        fns = {"render_field_all": (lambda: krf.render_field_all(packed, pts, vd, z, rd),
                                    lambda: krf.render_field_all_ref(field, pts, vd, z, rd)),
               "render_field_ins": (lambda: krf.render_field_ins(packed, pts, z, rd),
                                    lambda: krf.render_field_ins_ref(field, pts, z, rd))}
        for name, (k_fn, p_fn) in fns.items():
            p1, k1, k2, p2 = cuda_ms(p_fn), cuda_ms(k_fn), cuda_ms(k_fn), cuda_ms(p_fn)
            print(f"{name} K=64: kernel {min(k1, k2):.3f} ms, plain {min(p1, p2):.3f} ms "
                  f"(median of 10; R={R}, S={S}; {card})")
            out[name] = roofline(
                {"name": f"{name} K=64", "max_abs_err": worst[name], "ms": min(k1, k2),
                 "plain_ms": min(p1, p2)},
                field_macs(cfg, name.split("_")[-1]) * R * S,
                render_bytes(name, R, S, packed, cfg.ins_num))
    return out


CHILDREN = []                           # the processes this script starts


def phase(name):
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def look_at_poses(n, radius=4.0):
    """n camera-to-world poses on a circle around the origin, looking at it."""
    poses = []
    for th in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = np.array([radius * np.cos(th), radius * np.sin(th), 1.5])
        back = eye / np.linalg.norm(eye)                 # camera +z points away
        right = np.cross([0.0, 0.0, 1.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, up, back], 1)
        c2w[:3, 3] = eye
        poses.append(c2w.astype(np.float32))
    return np.stack(poses)


def main():
    t_start = time.perf_counter()
    phase("1 card")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(smi)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from dmnerf_torch.core.sampling import sample_pdf, z_val_sample
    from dmnerf_torch.kernels import build
    from dmnerf_torch.kernels import render_field as krf
    from dmnerf_torch.models.convert import save_tar
    from dmnerf_torch.models.fields import FieldConfig, init_field_params

    phase("2 build")
    t0 = time.perf_counter()
    for name, (so, seconds) in build.build_all(["render_field", "field"]).items():
        print(f"built {os.path.relpath(so, REPO)} in {seconds:.1f} s")
        print("\n".join(l for l in so.with_suffix(".log").read_text().splitlines()
                        if "registers" in l or "spill" in l))
    print(f"build wall time {time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    build.load_render_field()
    build.load_field()

    phase("3 kernels vs plain versions (flagship 8x256, K=32, bf16, 4096 rays)")
    cfg = FieldConfig(**FLAGSHIP, ins_num=32)
    gen = torch.Generator().manual_seed(0)
    coarse = init_field_params(gen, cfg, device=dev).eval()
    fine = init_field_params(gen, cfg, device=dev).eval()
    rng = np.random.default_rng(0)
    R = 4096
    ro = torch.from_numpy((rng.normal(size=(R, 3)) * 0.3).astype(np.float32)).to(dev)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd = torch.from_numpy(rd / np.linalg.norm(rd, axis=-1, keepdims=True)).to(dev)
    vd = (rd / torch.linalg.norm(rd, dim=-1, keepdim=True))[:, None, :].contiguous()
    z_c = z_val_sample(R, 1.0, 12.0, 64, device=dev).contiguous()
    kernels = []
    with torch.no_grad():
        pts_c = ro[:, None] + rd[:, None] * z_c[:, :, None]
        pc, pf = krf.pack_field(coarse), krf.pack_field(fine)
        w_ref = krf.render_field_sigma_ref(coarse, pts_c, z_c, rd)
        w_k = krf.render_field_sigma(pc, pts_c, z_c, rd)
        z_s = sample_pdf(0.5 * (z_c[:, 1:] + z_c[:, :-1]), w_ref[:, 1:-1], 128, det=True)
        z_f = torch.sort(torch.cat([z_c, z_s], -1), -1)[0].contiguous()
        pts_f = ro[:, None] + rd[:, None] * z_f[:, :, None]
        all_ref = krf.render_field_all_ref(fine, pts_f, vd, z_f, rd)
        all_k = krf.render_field_all(pf, pts_f, vd, z_f, rd)
        torch.cuda.synchronize()
        errs = {"render_field_sigma": {"weights": (w_k, w_ref)},
                "render_field_all": dict(zip(("rgb", "depth", "ins_logits"),
                                             zip(all_k, all_ref)))}
        timing = {
            "render_field_sigma": (lambda: krf.render_field_sigma(pc, pts_c, z_c, rd),
                                   lambda: krf.render_field_sigma_ref(coarse, pts_c, z_c, rd)),
            "render_field_all": (lambda: krf.render_field_all(pf, pts_f, vd, z_f, rd),
                                 lambda: krf.render_field_all_ref(fine, pts_f, vd, z_f, rd)),
        }
        sig_last = {"render_field_sigma": coarse.density(pts_c[:, -1])[..., 0],
                    "render_field_all": fine.density(pts_f[:, -1])[..., 0]}
        for name, outs in errs.items():
            worst = max(check(name, out, got, want, sig_last[name])
                        for out, (got, want) in outs.items())
            # plain, kernel, kernel, plain: both see the same slice of the run
            k_fn, p_fn = timing[name]
            p1, k1, k2, p2 = cuda_ms(p_fn), cuda_ms(k_fn), cuda_ms(k_fn), cuda_ms(p_fn)
            ms, plain_ms = min(k1, k2), min(p1, p2)
            print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                  f"(median of 10; R=4096, S={z_c.shape[1] if 'sigma' in name else 192}; {card})")
            S_k = z_c.shape[1] if "sigma" in name else z_f.shape[1]
            kernels.append(roofline(
                {"name": name, "route": "cuda", "source": SRC, "replaces": REPLACES,
                 "heads": name.split("_")[-1], "launches": 0, "max_abs_err": worst,
                 "ms": ms, "plain_ms": plain_ms},
                field_macs(cfg, name.split("_")[-1]) * R * S_k,
                render_bytes(name, R, S_k, pf, cfg.ins_num)))
        against_k1_composite("render_field_all", all_k, pf, pts_f, vd, z_f, rd)
        k64 = wide_render_kernels(dev, card, ro, rd, vd, z_f)
        kernels[-1]["k64"] = k64["render_field_all"]

    phase("4 slice: dmnerf_torch.cli.test --render (boxroom128x8, flagship, bf16)")
    from dmnerf_torch.cli import test as cli
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "smoke.txt")
        with open(cfg_path, "w") as f:
            f.write("\n".join([
                "expname = smoke", f"basedir = {tmp}", "log_time = run",
                "datadir = ./data/synthetic/boxroom128x8", "N_samples = 64",
                "N_importance = 128", "N_test = 4096", "near = 1.0", "far = 12.0",
                "precision = bf16"] + [f"{k} = {v}" for k, v in FLAGSHIP.items()]) + "\n")
        scfg = FieldConfig(**FLAGSHIP, ins_num=SYNTHETIC_INS_NUM)
        gen = torch.Generator().manual_seed(1)
        sc, sf = init_field_params(gen, scfg), init_field_params(gen, scfg)
        os.makedirs(os.path.join(tmp, "smoke", "run"))
        save_tar(os.path.join(tmp, "smoke", "run", "000001.tar"), sc.state_dict(),
                 sf.state_dict(), 1)
        krf.reset_launches()
        t0 = time.perf_counter()
        savedir = cli.main(["--config", cfg_path, "--render", "--device", "cuda"])
        torch.cuda.synchronize()
        launches = dict(krf.LAUNCHES)
        print(f"cli render (scene generation included): {time.perf_counter() - t0:.1f} s; "
              f"launches {launches}")
        table = np.loadtxt(os.path.join(savedir, "test_results.txt"))
        print("test_results.txt:\n" + open(os.path.join(savedir, "test_results.txt")).read())
        expected = 2 * (128 * 128 // 4096)          # 2 test views x 4 chunks
        if table.shape != (3, 9) or not np.isfinite(table[:, 0]).all():
            raise AssertionError(f"test_results.txt: shape {table.shape}, PSNR {table[:, 0]}")
        if launches != {"render_field_sigma": expected, "render_field_all": expected,
                        "render_field_ins": 0, **F32_NONE}:
            raise AssertionError(f"launches {launches}, expected {expected} of K4 and K3")
        for k in kernels:
            k["launches"] = launches[k["name"]]

    phase("4b 32x32 render: kernels vs the plain unfused path (flagship, bf16)")
    from dmnerf_torch.eval.renderer import make_image_renderer
    sparams = {"coarse": sc.to(dev).eval(), "fine": sf.to(dev).eval()}
    small = SimpleNamespace(N_test=512, N_samples=64, N_importance=128, near=1.0, far=12.0)
    pose = look_at_poses(1)[0]
    Ks = np.array([[0.7 * 32, 0, 16], [0, -0.7 * 32, 16], [0, 0, -1.0]], np.float32)
    got = make_image_renderer(scfg, small, 32, 32, device=dev, use_pallas=True)(
        sparams, Ks, pose)
    want = make_image_renderer(scfg, small, 32, 32, device=dev, use_pallas=False)(
        sparams, Ks, pose)
    if not all(np.isfinite(g).all() for g in got):
        raise AssertionError("non-finite render")
    rgb_err, depth_err = np.abs(got[0] - want[0]), np.abs(got[3] - want[3])
    agree = float((got[1] == want[1]).mean())
    print(f"rgb err max {rgb_err.max():.3e} p99 {np.quantile(rgb_err, 0.99):.3e}; "
          f"depth err max {depth_err.max():.3e} p99 {np.quantile(depth_err, 0.99):.3e}; "
          f"labels agree on {agree:.4f} of pixels")
    # bf16 ulp flips in the kernel's activations move a few importance
    # samples across bins; the bulk of the image must agree tightly
    if not (np.quantile(rgb_err, 0.99) <= 5e-3 and np.quantile(depth_err, 0.99) <= 5e-2
            and agree >= 0.98):
        raise AssertionError("fused kernel render disagrees with the plain path")

    kernels += field_kernels_vs_plain(dev, card)
    train_launches = train_slice(dev)
    for k in kernels:
        if k["name"] in train_launches:
            k["launches"] = train_launches[k["name"]]
    with tempfile.TemporaryDirectory() as mesh_tmp:
        mesh_cfg = mesh_field(dev, mesh_tmp)
        kernels.append(ins_kernel_vs_plain(fine, pf, pts_f, vd, z_f, rd, card))
        kernels[-1]["k64"] = k64["render_field_ins"]
        kernels[-1]["launches"] = edit_slice(dev)["render_field_ins"]
        kernels += f32_builds(dev, card, ro, rd, vd, z_c, z_f, mesh_cfg)
        mesh_launches = mesh_slice(dev, card, mesh_cfg)
    with tempfile.TemporaryDirectory() as scenes_tmp:
        scene_launches, scene_errs, scene_secs = reference_scenes(card, scenes_tmp)
        scannet_launches, scannet_errs = scannet_slice(card)
        lpips_launches = lpips_and_trace(card, scenes_tmp, scene_secs)
    ray_mesh_launches = ray_mesh(dev, card)
    grid_launches = model_mesh(dev, card)
    for k in kernels:                   # the f32 entries hold phase 12's mesh launches
        k["launches"] += sum(p.get(k["name"], 0) for p in (
            mesh_launches, scene_launches, scannet_launches, lpips_launches, ray_mesh_launches,
            grid_launches))
        for errs in (scene_errs, scannet_errs):   # {config: max abs err} at the stress shapes
            if k["name"] in errs:
                k.setdefault("stress_max_abs_err", {}).update(errs[k["name"]])

    loaded = banned_modules()
    if loaded:
        raise AssertionError(f"the port loaded the JAX package, jax or a banned reader "
                             f"library: {loaded}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all ({card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def raw_errors(got, want):
    """(worst column's max abs error over its max |raw|, worst column's
    relative L2 error) of raw [..., C]."""
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    err = (got - want).abs()
    worst = float((err.amax(0) / want.abs().amax(0).clamp_min(1e-30)).max())
    l2 = float(((got - want).norm(dim=0) / want.norm(dim=0).clamp_min(1e-30)).max())
    return worst, l2


def grad_errors(field, packed, got, want):
    """({parameter: relative L2 error}, max abs error) of two FieldGrads, in
    the module layout."""
    from dmnerf_torch.kernels import field as kf
    pairs = list(zip(field.named_parameters(), kf.unpack_grads(packed, got.dw, got.db),
                     kf.unpack_grads(packed, want.dw, want.db)))
    rel = {n: float((a - b).norm() / b.norm().clamp_min(1e-30)) for (n, _), a, b in pairs}
    return rel, max(float((a - b).abs().max()) for _, a, b in pairs)


def field_cases(dev, ins_num, seed, R, Ss, dtype=torch.bfloat16):
    """The flagship field at ins_num (compute dtype dtype) from a seed, and for
    each S in Ss, R rays x S points (sorted z in [1, 12]) with a cotangent g
    for its raw, all from one numpy generator: yields (field, packed, pts,
    vd, pf, dirs, ppd, g)."""
    from dmnerf_torch.kernels import field as kf
    from dmnerf_torch.kernels.render_field import pack_field
    from dmnerf_torch.models.fields import FieldConfig, init_field_params
    cfg = FieldConfig(**FLAGSHIP, ins_num=ins_num, compute_dtype=dtype)
    field = init_field_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    packed = pack_field(field)
    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(R, 3)) * 0.3
    rd = rng.normal(size=(R, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    for S in Ss:
        z = np.sort(rng.uniform(1.0, 12.0, (R, S)), -1)
        pts = torch.tensor(ro[:, None] + rd[:, None] * z[..., None], dtype=torch.float32,
                           device=dev)
        vd = torch.tensor(rd[:, None], dtype=torch.float32, device=dev)
        pf, dirs, ppd = kf.flatten_inputs(pts, vd)
        g = torch.tensor(rng.normal(size=(R * S, cfg.ins_num + 5)) * 1e-3,
                         dtype=torch.float32, device=dev)
        yield field, packed, pts, vd, pf, dirs, ppd, g


def check_field_kernels(case, label, probe=True):
    """K1 and K2 vs their plain versions on one case (see field_case); raises
    outside the bars. probe: also show that the raw bar rejects an rgb bias
    off by 10% (a property of the bar at random weights, which phase 6
    establishes; a trained field's bias may be too small to show it).
    Returns (max abs raw error, max abs gradient error)."""
    from dmnerf_torch.kernels import field as kf
    field, packed, pts, vd, pf, dirs, ppd, g = case
    with torch.no_grad():
        raw_k, raw_p = kf.field_forward(packed, pts, vd), kf.field_forward_ref(field, pts, vd)
    gk = kf.field_backward(packed, pf, dirs, ppd, g)
    gk2 = kf.field_backward(packed, pf, dirs, ppd, g)
    gp = kf.field_backward_ref(packed, pf, dirs, ppd, g)
    g_ins = g.clone()
    g_ins[:, :4] = 0.0                      # a loss on the instance logits alone
    gz = kf.unpack_grads(packed, *kf.field_backward(packed, pf, dirs, ppd, g_ins)[:2])
    torch.cuda.synchronize()
    err = (raw_k - raw_p).abs()
    if raw_k.shape != raw_p.shape or not bool(torch.isfinite(raw_k).all()):
        raise AssertionError("K1: wrong shape or non-finite raw")
    col, l2 = raw_errors(raw_k, raw_p)
    print(f"K1 {label}: raw max abs err {err.max().item():.3e} (median "
          f"{err.median().item():.3e}); worst column {col:.3e} of its max|raw| "
          f"(tolerance {RAW_COL_TOL:.0e}), relative L2 {l2:.3e} (tolerance "
          f"{RAW_L2_TOL:.0e})")
    if col > RAW_COL_TOL or l2 > RAW_L2_TOL:
        raise AssertionError("K1 disagrees with its plain version")
    if probe:
        # the check must see a fault confined to the rgb columns
        faulty = raw_k.clone()
        faulty[..., :3] -= 0.1 * field.rgb_linear.bias.detach()
        _, l2_faulty = raw_errors(faulty, raw_p)
        print(f"K1 {label}: with the rgb bias off by 10%, relative L2 {l2_faulty:.3e}")
        if l2_faulty <= RAW_L2_TOL:
            raise AssertionError("the K1 check passes raw with the rgb bias off by 10%")
    errs, abs_err = grad_errors(field, packed, gk, gp)
    name, e = max(errs.items(), key=lambda kv: kv[1])
    print(f"K2 {label}: worst gradient relative L2 err {e:.3e} ({name}; tolerance "
          f"{GRAD_TOL:.0e}); median over parameters {np.median(list(errs.values())):.3e}; "
          f"max abs err {abs_err:.3e}")
    if e > GRAD_TOL or not all(bool(torch.isfinite(t).all()) for t in gk[:2]):
        raise AssertionError("K2 disagrees with its plain version")
    if not (torch.equal(gk.dw, gk2.dw) and torch.equal(gk.db, gk2.db)):
        raise AssertionError("K2: two launches on the same inputs differ")
    trunk = sum(float(t.abs().sum()) for (n, _), t in zip(field.named_parameters(), gz)
                if n.startswith("mlps."))
    ins_out = float(gz[[n for n, _ in field.named_parameters()].index(
        "ins_linear.weight")].abs().sum())
    print(f"K2: bit-identical across two launches; instance-only loss: trunk "
          f"|grad| sum {trunk}, ins_linear {ins_out:.3e}")
    if trunk != 0.0 or ins_out == 0.0:
        raise AssertionError("K2 passes the instance branch's cotangent into the trunk")
    return err.max().item(), abs_err


def field_kernels_vs_plain(dev, card):
    """Phase 6: K1 and K2 vs their plain versions at the train step's shapes
    (K=32) and on the coarse shape at K=64, each timed alone."""
    from dmnerf_torch.kernels import field as kf

    phase("6 K1/K2 vs plain versions (flagship 8x256, K=32, bf16, 3072 rays x 64 / x 192; "
          "K=64 at 3072 x 64)")
    worst_raw, worst_grad = 0.0, 0.0
    for case in field_cases(dev, 32, 2, 3072, (64, 192)):
        e_raw, e_grad = check_field_kernels(case, f"P={case[4].shape[0]}")
        worst_raw, worst_grad = max(worst_raw, e_raw), max(worst_grad, e_grad)
    (wide,) = field_cases(dev, 64, 64, 3072, (64,))
    wide_err = check_field_kernels(wide, "K=64 P=196608")
    field, packed, pts, vd, pf, dirs, ppd, g = case

    def fwd_k():
        with torch.no_grad():
            kf.field_forward(packed, pts, vd)

    def fwd_p():
        with torch.no_grad():
            kf.field_forward_ref(field, pts, vd)

    def bwd_k():
        kf.field_backward(packed, pf, dirs, ppd, g)

    def bwd_p():
        kf.field_backward_ref(packed, pf, dirs, ppd, g)

    # plain, kernel, kernel, plain: both see the same slice of the run
    def pair(k_fn, p_fn, reps=10):
        p1, k1, k2, p2 = (cuda_ms(p_fn, reps), cuda_ms(k_fn, reps), cuda_ms(k_fn, reps),
                          cuda_ms(p_fn, reps))
        return min(k1, k2), min(p1, p2)

    ms1, plain1 = pair(fwd_k, fwd_p)
    ms2, plain2 = pair(bwd_k, bwd_p, reps=5)
    print(f"K1 field_forward: kernel {ms1:.3f} ms, plain {plain1:.3f} ms (P=589824; {card})")
    print(f"K2 field_backward (its forward recompute and dW pass included): kernel "
          f"{ms2:.3f} ms, plain {plain2:.3f} ms (P=589824; {card})")
    k1 = roofline({"name": "field_forward", "route": "cuda", "source": FIELD_SRC,
                   "replaces": K1_REPLACES, "launches": 0, "max_abs_err": worst_raw,
                   "ms": ms1, "plain_ms": plain1}, *field_work(case, "forward"))
    k2 = roofline({"name": "field_backward", "route": "cuda", "source": FIELD_SRC,
                   "replaces": K2_REPLACES, "launches": 0, "max_abs_err": worst_grad,
                   "ms": ms2, "plain_ms": plain2}, *field_work(case, "backward"))

    # K=64 on the coarse shape: K1 at CP 80, K2 on 16-row slabs
    wf, wp, wpts, wvd, wpf, wdirs, wppd, wg = wide
    for entry, err, k_fn, p_fn, reps, part in (
            (k1, wide_err[0], lambda: kf.field_forward(wp, wpts, wvd),
             lambda: kf.field_forward_ref(wf, wpts, wvd), 10, "forward"),
            (k2, wide_err[1], lambda: kf.field_backward(wp, wpf, wdirs, wppd, wg),
             lambda: kf.field_backward_ref(wp, wpf, wdirs, wppd, wg), 5, "backward")):
        with torch.no_grad():
            ms, plain = pair(k_fn, p_fn, reps)
        print(f"{entry['name']} K=64: kernel {ms:.3f} ms, plain {plain:.3f} ms "
              f"(P={wpf.shape[0]}; {card})")
        entry["k64"] = roofline({"name": f"{entry['name']} K=64", "max_abs_err": err,
                                 "ms": ms, "plain_ms": plain}, *field_work(wide, part))
    return [k1, k2]


def field_work(case, part):
    """(multiply-adds, bytes) of K1 (part "forward") or K2 ("backward") on a
    case of field_cases. K1 in: points, a direction per ray, the weights;
    out: raw fp32. K2 in: points, directions, the cotangent g, the weights;
    out: dW, db fp32."""
    field, packed, _, _, pf, dirs, _, _ = case
    P, C, w_bytes = pf.shape[0], field.cfg.ins_num + 5, weight_bytes(packed)
    if part == "forward":
        return (field_macs(field.cfg, "all") * P,
                P * 12 + dirs.shape[0] * 12 + w_bytes + P * C * 4)
    return (field_macs(field.cfg, "backward") * P,
            P * 12 + dirs.shape[0] * 12 + P * C * 4 + w_bytes + 2 * w_bytes)


def train_cfg(tmp, name, n_iters, extra=(), precision="bf16"):
    path = os.path.join(tmp, f"{name}.txt")
    with open(path, "w") as f:
        f.write("\n".join([
            f"expname = {name}", f"basedir = {tmp}", "log_time = run",
            "datadir = ./data/synthetic/boxroom128x8", "N_train = 3072", "N_samples = 64",
            "N_importance = 128", "N_test = 4096", "near = 1.0", "far = 12.0",
            f"precision = {precision}", "penalize", "tolerance = 0.05", "deta_w = 0.05",
            "lrate = 5e-4", f"n_iters = {n_iters}", "seed = 3", *extra]
            + [f"{k} = {v}" for k, v in FLAGSHIP.items()]) + "\n")
    return path


def train_slice(dev):
    """Phase 7: dmnerf_torch.cli.train at flagship width, then cli.test."""
    from dmnerf_torch.cli import test as cli_test
    from dmnerf_torch.cli import train as cli_train
    from dmnerf_torch.kernels import field as kf
    from dmnerf_torch.models.convert import load_tar

    phase("7 slice: dmnerf_torch.cli.train (boxroom128x8, flagship, N_train 3072, "
          "64+128 samples, penalizer, bf16, 30 steps)")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = train_cfg(tmp, "smoke", 29, ["i_print = 5", "i_save = 30", "i_test = 15"])
        kf.reset_launches()
        t0 = time.perf_counter()
        cli_train.main(["--config", cfg, "--device", "cuda"])
        torch.cuda.synchronize()
        launches = dict(kf.LAUNCHES)
        print(f"cli train, 30 steps + 1 eval (scene generation included): "
              f"{time.perf_counter() - t0:.1f} s; launches {launches}")
        ldir = os.path.join(tmp, "smoke", "run")
        lines = [json.loads(l) for l in open(os.path.join(ldir, "metrics.jsonl"))]
        losses = [l[k] for l in lines for k in ("total_loss", "rgb_loss", "ins_loss",
                                                "psnr_fine", "psnr_coarse")]
        print(f"metrics.jsonl: {len(lines)} lines, last {lines[-1]}")
        if len(lines) != 6 or not np.isfinite(losses).all():
            raise AssertionError("train: a printed loss is not finite, or lines are missing")
        if launches != {"field_forward": 60, "field_backward": 60,
                        "field_forward_f32": 0, "field_backward_f32": 0}:
            raise AssertionError(f"launches {launches}, expected 60 of each (2 per step)")
        if not os.path.isdir(os.path.join(ldir, "testset_000015")):
            raise AssertionError("train: no in-train eval at step 15")
        savedir = cli_test.main(["--config", cfg, "--render", "--device", "cuda"])
        table = np.loadtxt(os.path.join(savedir, "test_results.txt"))
        print(f"cli test --render from {os.path.basename(savedir)}: PSNR {table[:, 0]}")
        if not savedir.endswith("render_test_000030") or not np.isfinite(table[:, 0]).all():
            raise AssertionError("test CLI did not render the trained 000030.tar")

        runs = []
        for name in ("replay_a", "replay_b"):
            cli_train.main(["--config", train_cfg(tmp, name, 2, ["i_print = 3", "i_save = 3",
                                                                 "i_test = 0"]),
                            "--device", "cuda"])
            runs.append(load_tar(os.path.join(tmp, name, "run", "000003.tar")))
        same = all(torch.equal(a[k], b[k]) for a, b in zip(runs[0][:2], runs[1][:2]) for k in a)
        print(f"two 3-step runs from seed 3: parameters bit-identical: {same}")
        if not same:
            raise AssertionError("train: two runs from one seed differ")
    return launches


def ins_kernel_vs_plain(fine, packed, pts, vd, z, rd, card):
    """Phase 9: K5 vs its plain version on phase 3's fine z-union, which is
    what an accumulated-label pass composites (det linspace + 128 det
    sample_pdf samples, sorted)."""
    from dmnerf_torch.kernels import render_field as krf

    phase("9 K5 vs its plain version (flagship 8x256, K=32, bf16, 4096 rays x 192)")
    R, S = z.shape
    with torch.no_grad():
        got = krf.render_field_ins(packed, pts, z, rd)
        want = krf.render_field_ins_ref(fine, pts, z, rd)
        k3_ins = krf.render_field_all(packed, pts, vd, z, rd)[2]
        torch.cuda.synchronize()
        worst = check("render_field_ins", "ins_logits", got, want,
                      fine.density(pts[:, -1])[..., 0])
        # the same trunk and instance branch as K3's, with the rgb rows of the
        # output matmul left out: they add exact zeros to these columns
        vs_k3 = float((got - k3_ins).abs().max())
        print(f"render_field_ins vs render_field_all's logits: max abs diff {vs_k3:.3e}")
        if not torch.equal(got, k3_ins):
            raise AssertionError("K5's logits differ from K3's")

        def k5():
            krf.render_field_ins(packed, pts, z, rd)

        def k3():
            krf.render_field_all(packed, pts, vd, z, rd)

        def plain():
            krf.render_field_ins_ref(fine, pts, z, rd)

        # plain, K5, K3, K5, K3, plain: all three see the same slice of the run
        p1, a1, b1, a2, b2, p2 = (cuda_ms(plain), cuda_ms(k5), cuda_ms(k3), cuda_ms(k5),
                                  cuda_ms(k3), cuda_ms(plain))
    ms, k3_ms, plain_ms = min(a1, a2), min(b1, b2), min(p1, p2)
    print(f"render_field_ins: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, K3 at the same "
          f"shape {k3_ms:.3f} ms (K5/K3 {ms / k3_ms:.3f}; median of 10; R={R}, S={S}; {card})")
    return roofline({"name": "render_field_ins", "route": "cuda", "source": SRC,
                     "replaces": REPLACES, "heads": "ins", "launches": 0, "max_abs_err": worst,
                     "ms": ms, "plain_ms": plain_ms},
                    field_macs(fine.cfg, "ins") * R * S,
                    render_bytes("render_field_ins", R, S, packed, fine.cfg.ins_num))


def held_f32(name, got, want, sigma_last=None, quiet=False):
    """The max abs error of an f32 build's output per ray (per point for raw)
    over the rays off the last-sample step, held to F32_TOL of max(1, max
    |want|); at most MAX_STEP_RAYS rays may be exempt. Printed unless
    quiet."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite")
    err = (got - want).abs().reshape(got.shape[0], -1).amax(1)
    step = (sigma_last.abs() < F32_STEP if sigma_last is not None
            else torch.zeros_like(err, dtype=torch.bool))
    worst, scale = float(err[~step].max()), max(1.0, float(want.abs().max()))
    if not quiet:
        print(f"{name} {tuple(got.shape)}: max abs err {worst:.3e}, {worst / scale:.3e} of "
              f"max(1, max |want|) (tolerance {F32_TOL:.0e}); {int(step.sum())} rays exempt at "
              f"the last-sample step (raw max {float(err.max()):.3e})")
    if worst > F32_TOL * scale or int(step.sum()) > MAX_STEP_RAYS:
        raise AssertionError(f"{name} disagrees with its plain f32 version")
    return worst


def f32_views(dev, card):
    """Phase 12: one f32 render view (128x128, N_test 4096, 64+128 samples,
    the flagship pair at K=32) and one f32 edit view (one rigid object
    moved, the same field and rays), each on the kernels and on the plain
    path (use_pallas False). Every f32 composite launch is held to its plain
    version on its inputs (composites_held); the kernels' view is held to
    the plain one at VIEW_OFF's bars."""
    from dmnerf_torch.edit import manipulator
    from dmnerf_torch.eval.renderer import make_image_renderer
    from dmnerf_torch.models.fields import FieldConfig, init_field_params

    cfg = FieldConfig(**FLAGSHIP, ins_num=32, compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(16)
    params = {k: init_field_params(gen, cfg, device=dev).eval() for k in ("coarse", "fine")}
    bench = SimpleNamespace(N_test=4096, N_samples=64, N_importance=128, near=1.0, far=12.0)
    K = np.array([[0.7 * 128, 0, 64], [0, -0.7 * 128, 64], [0, 0, -1.0]], np.float32)
    pose = look_at_poses(4)[1].astype(np.float64)
    moved = (translation(0.3) @ pose)[None]

    def as_numpy(out):
        return [o.detach().cpu().numpy() if torch.is_tensor(o) else np.asarray(o) for o in out]

    fns = {}
    for kernels in (True, False):
        render = make_image_renderer(cfg, bench, 128, 128, device=dev, use_pallas=kernels)
        edit = manipulator.make_pose_image_manipulator(
            cfg, params, bench, [{"mode": "rigid"}], [1], 128, 128, K, device=dev,
            use_pallas=kernels)
        fns["render", kernels] = lambda r=render: as_numpy(r(params, K, pose.astype(np.float32)))
        fns["edit", kernels] = lambda e=edit: as_numpy(e(pose, moved, np.zeros(1)))
    with torch.no_grad():
        for what in ("render", "edit"):
            with composites_held({}) as worst:
                views = {kernels: fns[what, kernels]() for kernels in (True, False)}
            # render: rgb, label, conf, depth; edit: rgb, label, ..., conf
            k_out, p_out = views[True], views[False]
            rgb_err = np.abs(k_out[0] - p_out[0]).reshape(128 * 128, -1).max(1)
            off = rgb_err > F32_TOL * max(1.0, float(np.abs(p_out[0]).max()))
            if what == "render":
                off |= np.abs(k_out[3] - p_out[3]).reshape(-1) > F32_TOL * max(
                    1.0, float(np.abs(p_out[3]).max()))
            relabelled = int((k_out[1].reshape(-1) != p_out[1].reshape(-1)).sum())
            print(f"f32 {what} view, 128x128{' (1 rigid object)' if what == 'edit' else ''}, "
                  f"kernels against the plain path (use_pallas False): every f32 composite "
                  f"launch within F32_TOL of its plain version ({', '.join(f'{k} {v:.2e}' for k, v in worst.items())} of scale); "
                  f"the views: rgb max |diff| {float(rgb_err.max()):.3e}, median "
                  f"{float(np.median(rgb_err)):.3e}, {int(off.sum())} pixels off F32_TOL, "
                  f"{relabelled} relabelled ({card})")
            if (max(int(off.sum()), relabelled) > VIEW_OFF * rgb_err.size
                    or float(np.median(rgb_err)) > F32_TOL / 10):
                raise AssertionError(f"f32 {what} view: the kernels disagree with the plain path")


def f32_builds(dev, card, ro, rd, vd, z_c, z_f, mesh_cfg):
    """Phase 12: the f32 builds of K1-K5 against their plain f32 versions,
    an f32 render and edit view against the plain path, then the train,
    render, edit and mesh paths in f32 through their entry points (the mesh
    of phase 7b's field, mesh_cfg). Returns the kernels-line entries of the
    f32 builds."""
    from dmnerf_torch.cli import test as cli_test
    from dmnerf_torch.cli import train as cli_train
    from dmnerf_torch.edit import runner
    from dmnerf_torch.kernels import field as kf
    from dmnerf_torch.kernels import render_field as krf
    from dmnerf_torch.models.fields import FieldConfig, init_field_params

    phase("12 the f32 builds vs their plain f32 versions (flagship 8x256, K=32, 4096 rays; "
          "3072 rays x 64 / x 192; a render and an edit view), then cli.train, "
          "cli.test --render, an edit and cli.test --mesh in f32")
    cfg = FieldConfig(**FLAGSHIP, ins_num=32, compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(12)
    coarse, fine = (init_field_params(gen, cfg, device=dev).eval() for _ in range(2))
    pc, pf = krf.pack_field(coarse), krf.pack_field(fine)
    R = z_c.shape[0]
    pts_c = ro[:, None] + rd[:, None] * z_c[:, :, None]
    pts_f = ro[:, None] + rd[:, None] * z_f[:, :, None]
    entries = []

    def timed(entry, k_fn, p_fn, work, reps=3):
        # plain, kernel, kernel, plain: both see the same slice of the run
        p1, k1, k2, p2 = (cuda_ms(p_fn, reps, 1), cuda_ms(k_fn, reps, 1), cuda_ms(k_fn, reps, 1),
                          cuda_ms(p_fn, reps, 1))
        entry.update(route="cuda", launches=0, ms=min(k1, k2), plain_ms=min(p1, p2))
        print(f"{entry['name']}: kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms "
              f"(kernel/plain {entry['ms'] / entry['plain_ms']:.3f}; median of {reps}; {card})")
        return roofline_f32(entry, *work)

    with torch.no_grad():
        sig_c = coarse.density(pts_c[:, -1])[..., 0]
        sig_f = fine.density(pts_f[:, -1])[..., 0]
        for name, outs, k_fn, p_fn, S, sig in (
                ("render_field_sigma", ("weights",),
                 lambda: krf.render_field_sigma(pc, pts_c, z_c, rd),
                 lambda: krf.render_field_sigma_ref(coarse, pts_c, z_c, rd), z_c.shape[1], sig_c),
                ("render_field_all", ("rgb", "depth", "ins_logits"),
                 lambda: krf.render_field_all(pf, pts_f, vd, z_f, rd),
                 lambda: krf.render_field_all_ref(fine, pts_f, vd, z_f, rd), z_f.shape[1], sig_f),
                ("render_field_ins", ("ins_logits",),
                 lambda: krf.render_field_ins(pf, pts_f, z_f, rd),
                 lambda: krf.render_field_ins_ref(fine, pts_f, z_f, rd), z_f.shape[1], sig_f)):
            got, want = k_fn(), p_fn()
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            worst = max(held_f32(f"{name}_f32 {o}", a, b, sig) for o, a, b in zip(outs, got, want))
            heads = name.split("_")[-1]
            entries.append(timed(
                {"name": f"{name}_f32", "source": SRC, "replaces": REPLACES, "heads": heads,
                 "max_abs_err": worst}, k_fn, p_fn,
                (field_macs(cfg, heads) * R * S, render_bytes(name, R, S, pf, cfg.ins_num))))

    def check_k1_k2(case):
        """K1's raw and K2's gradients against their plain f32 versions on a
        case of field_cases, K2 bit-identical across two launches, and the
        peak device memory of K2's first launch. Returns (max abs raw error,
        max abs gradient error)."""
        field, packed, pts, cvd, pts_flat, dirs, ppd, g = case
        P, C = pts_flat.shape[0], field.cfg.ins_num + 5
        with torch.no_grad():
            raw_k, raw_p = kf.field_forward(packed, pts, cvd), kf.field_forward_ref(field, pts, cvd)
        e_raw = held_f32(f"field_forward_f32 raw P={P}", raw_k.reshape(-1, C),
                         raw_p.reshape(-1, C))
        del raw_k, raw_p
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gk = kf.field_backward(packed, pts_flat, dirs, ppd, g)
        torch.cuda.synchronize()
        print(f"field_backward_f32 P={P}: peak device memory of the call "
              f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB (scratch, "
              f"partials and outputs; {card})")
        gk2 = kf.field_backward(packed, pts_flat, dirs, ppd, g)
        gp = kf.field_backward_ref(packed, pts_flat, dirs, ppd, g)
        torch.cuda.synchronize()
        rel, e_grad = grad_errors(field, packed, gk, gp)
        worst_name, e = max(rel.items(), key=lambda kv: kv[1])
        print(f"field_backward_f32 P={P}: worst gradient relative L2 err {e:.3e} "
              f"({worst_name}; tolerance {F32_TOL:.0e}); max abs err {e_grad:.3e}")
        if e > F32_TOL or not all(bool(torch.isfinite(t).all()) for t in gk[:2]):
            raise AssertionError(f"K2's f32 build disagrees with its plain version at P={P}")
        if not (torch.equal(gk.dw, gk2.dw) and torch.equal(gk.db, gk2.db)):
            raise AssertionError(f"K2's f32 build: two launches on the same inputs differ (P={P})")
        return e_raw, e_grad

    # the train step's coarse (3072 x 64) and fine (3072 x 192) shapes, each
    # held and timed (the entry: the coarse one, the fine under "fine")
    cases = list(field_cases(dev, 32, 2, 3072, (64, 192), torch.float32))
    errs = [check_k1_k2(c) for c in cases]
    e_raw, e_grad = (max(e[i] for e in errs) for i in range(2))
    k1, k2 = ({"name": "field_forward_f32", "source": FIELD_SRC, "replaces": K1_REPLACES,
               "max_abs_err": e_raw},
              {"name": "field_backward_f32", "source": FIELD_SRC, "replaces": K2_REPLACES,
               "max_abs_err": e_grad})
    for case in cases:
        field, packed, pts, cvd, pts_flat, dirs, ppd, g = case
        P = pts_flat.shape[0]
        for entry, k_fn, p_fn, part in (
                (k1, lambda: kf.field_forward(packed, pts, cvd),
                 lambda: kf.field_forward_ref(field, pts, cvd), "forward"),
                (k2, lambda: kf.field_backward(packed, pts_flat, dirs, ppd, g),
                 lambda: kf.field_backward_ref(packed, pts_flat, dirs, ppd, g), "backward")):
            with torch.no_grad():
                got = timed(entry if case is cases[0] else {"name": f"{entry['name']} P={P}"},
                            k_fn, p_fn, field_work(case, part))
            if case is not cases[0]:
                entry["fine"] = got
    entries += [k1, k2]
    del cases
    f32_views(dev, card)

    def counted(what, fn, want):
        """fn() with its f32 composite launches held to their plain versions
        (composites_held; the held runs' seconds include the plain path's)."""
        kf.reset_launches()
        krf.reset_launches()
        t0 = time.perf_counter()
        with composites_held({}) as worst:
            out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in {**kf.LAUNCHES, **krf.LAUNCHES}.items() if v}
        print(f"{what} in f32: {time.perf_counter() - t0:.1f} s; launches {got}"
              + "".join(f"; {k}_f32 within {v:.2e} of scale of its plain version"
                        for k, v in worst.items()))
        want = want(out) if callable(want) else want
        if got != want:
            raise AssertionError(f"{what} in f32: launches {got}, expected {want}")
        return out, got

    with tempfile.TemporaryDirectory() as tmp:
        path = train_cfg(tmp, "f32", 2, ["i_print = 3", "i_save = 3", "i_test = 0"],
                         precision="f32")
        _, train_l = counted("cli.train, 3 steps", lambda: cli_train.main(
            ["--config", path, "--device", "cuda"]),
            {"field_forward_f32": 6, "field_backward_f32": 6})
        lines = [json.loads(l) for l in open(os.path.join(tmp, "f32", "run", "metrics.jsonl"))]
        if not np.isfinite([l[k] for l in lines for k in ("total_loss", "psnr_fine")]).all():
            raise AssertionError(f"f32 train: a printed loss is not finite: {lines}")
        views = 2 * (128 * 128 // 4096)              # 2 test views x 4 chunks
        savedir, render_l = counted("cli.test --render", lambda: cli_test.main(
            ["--config", path, "--render", "--device", "cuda"]),
            {"render_field_sigma_f32": views, "render_field_all_f32": views})
        table = np.loadtxt(os.path.join(savedir, "test_results.txt"))
        print(f"f32 render from {os.path.basename(savedir)}: PSNR {table[:, 0]}")
        if not savedir.endswith("render_test_000003") or not np.isfinite(table[:, 0]).all():
            raise AssertionError("f32 render: no finite PSNR from the trained 000003.tar")

        args, scene, _ = cli_train.load(["--config", path, "--device", "cuda"])
        args.ins_num = scene.ins_num
        args.target_label, args.use_pallas, args.mani_type = 1, True, "rigid"
        ecfg = FieldConfig.from_args(args)
        if ecfg.compute_dtype != torch.float32:
            raise AssertionError("precision f32 did not give an f32 field")
        gen = torch.Generator().manual_seed(11)
        params = {k: init_field_params(gen, ecfg, device=dev).eval() for k in ("coarse", "fine")}
        sel = scene.i_test
        chunks = len(sel) * -(-scene.H * scene.W // args.N_test)
        trans_dicts = {"transformations": [{"transformation": translation(0.3).tolist(),
                                            "mode": "translation"}]}
        res, edit_l = counted("manipulator_eval (1 object)", lambda: runner.manipulator_eval(
            ecfg, params, scene.poses[sel], scene.hwk, trans_dicts, os.path.join(tmp, "edit"),
            scene.ins_rgbs, args, gt_rgbs=scene.images[sel], gt_labels=scene.gt_labels[sel],
            device=dev), {"field_forward_f32": chunks * 4, "render_field_ins_f32": chunks * 2})
        table = np.loadtxt(os.path.join(tmp, "edit", "translation", "test_results.txt"))
        print(f"f32 edit: PSNR {table[:, 0]}")
        if not np.isfinite(table[:, 0]).all() or not np.isfinite(res[0]):
            raise AssertionError("f32 edit: PSNR not finite")

    def mesh_launches(savedir):
        from dmnerf_torch.mesh.extract import DENSITY_BATCH
        from dmnerf_torch.mesh.ply import read_ply
        verts, faces = read_ply(os.path.join(savedir, "color_mesh.ply"))
        n = -(-len(verts) // 4096)
        print(f"f32 mesh at grid 64: {len(verts)} vertices, {len(faces)} faces")
        if not len(faces):
            raise AssertionError("f32 mesh: empty")
        return {"field_forward_f32": -(-64 ** 3 // DENSITY_BATCH),
                "render_field_sigma_f32": n, "render_field_all_f32": n}
    _, mesh_l = counted("cli.test --mesh at grid 64", lambda: cli_test.main(
        ["--config", mesh_cfg, "--mesh", "--mesh_grid_dim", "64", "--mesh_extents", "12,12,12",
         "--precision", "f32", "--device", "cuda"]), mesh_launches)
    for entry in entries:
        # K1: the train run's; every kernel: the mesh run's on top
        entry["launches"] = ({**edit_l, **render_l, **train_l}[entry["name"]]
                             + mesh_l.get(entry["name"], 0))
    return entries


def translation(dx):
    t = np.eye(4)
    t[0, 3] = dx
    return t


def edit_slice(dev):
    """Phase 10: manipulator_eval and manipulator_demo at flagship width, then
    a small edit through the kernels vs the plain path. Returns the launch
    counts of the manipulator_eval run."""
    from dmnerf_torch.cli import train as cli_train
    from dmnerf_torch.edit import runner
    from dmnerf_torch.kernels import field as kf
    from dmnerf_torch.kernels import render_field as krf
    from dmnerf_torch.models.fields import FieldConfig, init_field_params

    phase("10 slice: the edit runners (boxroom128x8, flagship, K=4, bf16, N_test 4096)")
    with tempfile.TemporaryDirectory() as tmp:
        # the flags and the scene through the train CLI's loader; the runners
        # read N_test, the samples, near/far, target_label and use_pallas
        args, scene, _ = cli_train.load(["--config", train_cfg(tmp, "edit", 1),
                                         "--device", "cuda"])
        args.ins_num = scene.ins_num
        args.target_label, args.use_pallas, args.mani_type = 1, True, "rigid"
        cfg = FieldConfig.from_args(args)
        # a random pair whose field has density and several labels in view,
        # so that moving label 1 moves pixels (at 8x8 on a CPU, most seeds
        # from 0 to 10 gave an empty view or one label everywhere)
        gen = torch.Generator().manual_seed(11)
        params = {k: init_field_params(gen, cfg, device=dev).eval() for k in ("coarse", "fine")}
        n_chunks = -(-scene.H * scene.W // args.N_test)
        sel = scene.i_test

        def run_counted(what, views, n_obj, fn):
            kf.reset_launches()
            krf.reset_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            got = {**kf.LAUNCHES, **krf.LAUNCHES}
            want = {"field_forward": views * n_chunks * 2 * (1 + n_obj), "field_backward": 0,
                    "render_field_sigma": 0, "render_field_all": 0,
                    "render_field_ins": views * n_chunks * (1 + n_obj),
                    "field_forward_f32": 0, "field_backward_f32": 0, **F32_NONE}
            print(f"{what}, {views} views x {n_chunks} chunks, {n_obj} object(s): "
                  f"{time.perf_counter() - t0:.1f} s; launches {got}")
            if got != want:
                raise AssertionError(f"{what}: launches {got}, expected {want}")
            return out, got

        trans_dicts = {"transformations": [{"transformation": translation(0.3).tolist(),
                                            "mode": "translation"}]}
        res, launches = run_counted("manipulator_eval", len(sel), 1, lambda: runner.manipulator_eval(
            cfg, params, scene.poses[sel], scene.hwk, trans_dicts, os.path.join(tmp, "eval"),
            scene.ins_rgbs, args, gt_rgbs=scene.images[sel], gt_labels=scene.gt_labels[sel],
            device=dev))
        out = os.path.join(tmp, "eval", "translation")
        want = sorted([f"{i}_{k}.png" for i in range(len(sel))
                       for k in ("rgb", "ins", "rgb_gt", "ins_gt")]
                      + ["matching_log.json", "test_results.txt"])
        table = np.loadtxt(os.path.join(out, "test_results.txt"))
        print("test_results.txt:\n" + open(os.path.join(out, "test_results.txt")).read())
        if sorted(os.listdir(out)) != want:
            raise AssertionError(f"manipulator_eval wrote {sorted(os.listdir(out))}")
        if table.shape != (len(sel) + 1, 9) or not np.isfinite(table[:, 0]).all() \
                or not np.isfinite(res[0]):
            raise AssertionError(f"test_results.txt: shape {table.shape}, PSNR {table[:, 0]}")

        objs = [{"obj_name": "box1", "tar_id": 1, "mani_mode": "translation"},
                {"obj_name": "box2", "tar_id": 2, "mani_mode": "deform", "deform_func": "sin"}]
        objs_trans = {"box1": [{"transformation": translation(d).tolist()} for d in (0.15, 0.3)]}
        views = np.asarray(scene.poses)[[sel[0], sel[-1]]]
        run_counted("manipulator_demo", 2, 2, lambda: runner.manipulator_demo(
            cfg, params, scene.hwk, objs_trans, os.path.join(tmp, "demo"), scene.ins_rgbs,
            objs, views, {}, args, device=dev))
        names = sorted(os.listdir(os.path.join(tmp, "demo", "rigid")))
        print(f"manipulator_demo wrote {names}")
        if names != sorted(f"{i}_{k}.png" for i in range(2)
                           for k in ("rgb", "ins", "ins_pred_mask")):
            raise AssertionError("manipulator_demo: missing pngs")
    edit_vs_plain(dev, cfg, params)
    return launches


def edit_vs_plain(dev, cfg, params):
    """Phase 10b: a 32x32 edit through the kernels vs the plain path, and the
    same comparison against two broken plain edits, which it must reject."""
    from dmnerf_torch.edit import manipulator

    phase("10b 32x32 edit: kernels vs the plain path, and two broken edits (flagship, K=4)")
    small = SimpleNamespace(N_test=512, N_samples=64, N_importance=128, near=1.0, far=12.0)
    pose = look_at_poses(1)[0].astype(np.float64)
    Ks = np.array([[0.7 * 32, 0, 16], [0, -0.7 * 32, 16], [0, 0, -1.0]], np.float32)
    tar = (translation(0.3) @ pose)[None]

    def edit(use_pallas, move=1):
        run = manipulator.make_pose_image_manipulator(
            cfg, params, small, [{"mode": "rigid"}], [move], 32, 32, Ks, device=dev,
            use_pallas=use_pallas)
        rgb, label, _, _ = run(pose, tar, np.zeros(1))
        return rgb[:1024].cpu().numpy(), label[:1024].cpu().numpy()

    def diff(a, b):
        err = np.abs(a[0] - b[0])
        moved = (err.max(-1) > EDIT_RGB_STEP) | (a[1] != b[1])
        return float(err.mean()), float(moved.mean())

    got, want = edit(True), edit(False)
    unedited = edit(False, move=-1)           # no point carries label -1
    off_by_one = edit(False, move=2)
    real, calls = manipulator.exchanger, [0]

    def first_exchange_only(ori_raw, *rest):
        calls[0] += 1                          # odd calls: pass 1; even: pass 2
        return real(ori_raw, *rest) if calls[0] % 2 else ori_raw

    manipulator.exchanger = first_exchange_only
    try:
        skipped = edit(False)
    finally:
        manipulator.exchanger = real
    if not (np.isfinite(got[0]).all() and np.isfinite(want[0]).all()):
        raise AssertionError("non-finite edit")
    print(f"bars: mean abs rgb err <= {EDIT_MEAN_TOL:.0e}, pixels moved by > {EDIT_RGB_STEP:.0e} "
          f"or relabelled <= {EDIT_FRAC_TOL:.0%}")
    wrong = []
    for name, other in (("plain edit", want), ("plain, unedited", unedited),
                        ("plain, move label off by one", off_by_one),
                        ("plain, second exchange skipped", skipped)):
        mean, frac = diff(got, other)
        relabelled = float((got[1] != other[1]).mean())
        held = mean <= EDIT_MEAN_TOL and frac <= EDIT_FRAC_TOL
        print(f"kernel edit vs {name}: mean abs rgb err {mean:.3e}, moved or relabelled "
              f"{frac:.4f} of pixels (relabelled {relabelled:.4f}): "
              f"{'within' if held else 'outside'} the bars")
        if held != (name == "plain edit"):
            wrong.append(name)
    if wrong:
        raise AssertionError(f"the edit bars judge wrongly: {wrong}")


def mesh_field(dev, tmp):
    """Phase 7b: the field that phases 12 and 13 mesh, trained through
    dmnerf_torch.cli.train. Returns its config file."""
    from dmnerf_torch.cli import train as cli_train
    from dmnerf_torch.kernels import field as kf

    phase(f"7b the field the mesh phases use: dmnerf_torch.cli.train (boxroom128x8, flagship, "
          f"N_train 3072, 64+128 samples, penalizer, bf16, {MESH_STEPS} steps)")
    path = train_cfg(tmp, "mesh", MESH_STEPS - 1, [f"i_print = {MESH_STEPS // 4}",
                                                   f"i_save = {MESH_STEPS}", "i_test = 0"])
    kf.reset_launches()
    t0 = time.perf_counter()
    cli_train.main(["--config", path, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {k: v for k, v in kf.LAUNCHES.items() if v}
    lines = [json.loads(l) for l in open(os.path.join(tmp, "mesh", "run", "metrics.jsonl"))]
    print(f"cli train, {MESH_STEPS} steps: {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}; last metrics {lines[-1]}")
    if launches != {"field_forward": 2 * MESH_STEPS, "field_backward": 2 * MESH_STEPS}:
        raise AssertionError(f"mesh field training: launches {launches}")
    if not np.isfinite([l[k] for l in lines for k in ("total_loss", "psnr_fine")]).all():
        raise AssertionError(f"mesh field training: a printed loss is not finite: {lines}")
    return path


def mesh_slice(dev, card, path):
    """Phase 13: dmnerf_torch.cli.test --mesh of phase 7b's field at grid
    256, with the seconds of each stage; then its labels against the plain
    route and a slice of its grid through K1 against the plain forward.
    Returns the launch counts of the CLI run."""
    from dmnerf_torch import native
    from dmnerf_torch.cli import test as cli_test
    from dmnerf_torch.kernels import field as kf
    from dmnerf_torch.kernels import render_field as krf
    from dmnerf_torch.mesh import extract
    from dmnerf_torch.models.fields import FieldConfig

    phase("13 slice: dmnerf_torch.cli.test --mesh (phase 7b's field, flagship, K=4, bf16, "
          "grid 256, extents 12,12,12)")
    t0 = time.perf_counter()
    native_ok = native.load() is not None
    print(f"native marching module (g++ on native/marching.cpp unless build/native/ holds a "
          f"current one): {'loaded' if native_ok else 'NOT built, the numpy path runs'} in "
          f"{time.perf_counter() - t0:.1f} s")

    stages, seen, k1_events = {}, {}, []

    def timed(name, fn, keep=False):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t
            if keep:
                seen[name] = (a, out)
            return out
        return wrapper

    def to_device(a, device):
        name = "host->device (grid)" if len(a) == 256 ** 3 else "host->device (rays)"
        return timed(name, originals["to_device"])(a, device)

    def k1(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = originals["field_forward"](*a, **k)
        e1.record()
        k1_events.append((e0, e1))
        return out

    def density_fn(*a, **k):
        return timed("density (host->device, K1, column 3 back)",
                     originals["make_density_fn"](*a, **k))

    def label_fn(*a, **k):
        return timed("labels (host->device, K4 + K3, argmax back)",
                     originals["make_label_fn"](*a, **k), keep=True)

    patches = {(cli_test, "load_dataset"): lambda fn: timed("scene (generated)", fn),
               (cli_test, "load_fields"): lambda fn: timed("checkpoint", fn),
               (extract, "grid_within_bound"): lambda fn: timed("grid", fn),
               (extract, "to_device"): lambda fn: to_device,
               (extract, "field_forward"): lambda fn: k1,
               (extract, "make_density_fn"): lambda fn: density_fn,
               (extract, "marching_cubes"): lambda fn: timed("marching cubes", fn),
               (extract, "clean_mesh"): lambda fn: timed("cleanup", fn, keep=True),
               (extract, "vertex_rays"): lambda fn: timed("normals and vertex rays", fn),
               (extract, "make_label_fn"): lambda fn: label_fn,
               (extract, "write_ply"): lambda fn: timed("PLY writes", fn)}
    originals = {name: getattr(mod, name) for mod, name in patches}
    kf.reset_launches()
    krf.reset_launches()
    for (mod, name), patch in patches.items():
        setattr(mod, name, patch(originals[name]))
    try:
        t0 = time.perf_counter()
        savedir = cli_test.main(["--config", path, "--mesh", "--mesh_extents", "12,12,12",
                                 "--device", "cuda"])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for mod, name in patches:
            setattr(mod, name, originals[name])
    launches = {k: v for k, v in {**kf.LAUNCHES, **krf.LAUNCHES}.items() if v}
    verts, faces, _ = seen["cleanup"][1]
    (_, rays_o, rays_d), labels = seen["labels (host->device, K4 + K3, argmax back)"]
    V, F = len(verts), len(faces)
    k1_ms = sum(a.elapsed_time(b) for a, b in k1_events)
    print(f"cli test --mesh: {total:.3f} s in all (the scene's generation and the "
          f"checkpoint included); V {V}, F {F} after cleanup; {len(np.unique(labels))} labels "
          f"{np.bincount(labels).tolist()}; launches {launches} ({card})")
    print(f"stages (host clock, each ending in a device sync; {card}):")
    for name, secs in stages.items():
        print(f"  {name}: {secs:.3f} s")
    print(f"  K1 inside density: {k1_ms / 1e3:.3f} s by CUDA events ({len(k1_events)} launches)")
    print(f"  marching cubes path: {'native (C++)' if native_ok else 'numpy'}")
    print(f"  the rest (config, axis swap, occupancy, transforms, Python): "
          f"{total - sum(stages.values()):.3f} s")
    plys = sorted(f for f in os.listdir(savedir) if f.endswith(".ply"))
    want = {"field_forward": -(-256 ** 3 // extract.DENSITY_BATCH),
            "render_field_sigma": -(-V // 4096), "render_field_all": -(-V // 4096)}
    if plys != ["color_mesh.ply", "mesh.ply"] or F == 0 or len(np.unique(labels)) < 2:
        raise AssertionError(f"mesh: PLYs {plys}, {F} faces, labels {np.unique(labels)}")
    if launches != want:
        raise AssertionError(f"mesh: launches {launches}, expected {want}")

    # the labels of the first N_test vertex rays through the plain unfused route
    cfg = FieldConfig(**FLAGSHIP, ins_num=SYNTHETIC_INS_NUM)
    params, _ = cli_test.load_fields(cli_test.latest_tar(os.path.dirname(savedir)), cfg, dev)
    args = SimpleNamespace(N_samples=64, N_importance=128)
    plain = extract.make_label_fn(cfg, args, 4096, device=dev, use_pallas=False)(
        params, rays_o[:4096], rays_d[:4096])
    agree = float((plain == labels[:4096]).mean())
    print(f"labels of the first 4096 vertex rays: kernels vs the plain unfused route agree on "
          f"{agree:.4f} (bar 0.98)")
    if agree < 0.98:
        raise AssertionError("mesh labels through K4 + K3 disagree with the plain route")

    # the density grid as extract_mesh makes it, on the card
    grid, _ = extract.grid_within_bound([-1.0, 1.0], np.full(3, 12.0), np.eye(4), 256)
    q = np.ascontiguousarray(grid[:, [0, 2, 1]], np.float32)
    q[:, 1] *= -1
    del grid
    fine = params["fine"]
    with torch.no_grad():
        mid = q.shape[0] // 2
        pts = torch.from_numpy(q[mid:mid + 589824]).to(dev)
        vd = torch.zeros_like(pts)
        raw_k = kf.field_forward(krf.pack_field(fine), pts, vd)
        raw_p = kf.field_forward_ref(fine, pts, vd)
        torch.cuda.synchronize()
    col, l2 = raw_errors(raw_k, raw_p)
    print(f"K1 on 589,824 grid points vs the plain forward: worst column {col:.3e} of its "
          f"max|raw| (tolerance {RAW_COL_TOL:.0e}), relative L2 {l2:.3e} (tolerance "
          f"{RAW_L2_TOL:.0e}); sigma max {float(raw_p[:, 3].max()):.2f}")
    if col > RAW_COL_TOL or l2 > RAW_L2_TOL or not bool(torch.isfinite(raw_k).all()):
        raise AssertionError("K1 on the density grid disagrees with its plain version")
    return launches



# phase 14: training steps of each stress config (the configs' own n_iters
# are 50,000 and 20,000)
STRESS_STEPS = 300
# modules the port must not load: the JAX package and the readers' old
# libraries
BANNED = ("jax", "dmnerf_tpu", "imageio", "h5py", "cv2", "PIL")


def banned_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def counted(what, want, fn):
    """fn() with every launch counter at 0 before it; its launches must be
    exactly `want` (a dict, or a function of fn's result giving one; every
    other counter 0). Returns (fn's result, seconds, the launches)."""
    from dmnerf_torch.kernels import field as kf
    from dmnerf_torch.kernels import render_field as krf
    kf.reset_launches()
    krf.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k: v for k, v in {**kf.LAUNCHES, **krf.LAUNCHES}.items() if v}
    want = {k: v for k, v in (want(out) if callable(want) else want).items() if v}
    print(f"{what}: {secs:.1f} s; launches {got}")
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    return out, secs, got


def stress_kernels_vs_plain(name, args, scene, params, edits):
    """Phase 14's comparisons on a stress config's trained field, at the
    config's own width and ins_num, against the plain versions and the bars
    of phases 3, 6 and 9: K1 and K2 on one training batch (N_train pixels of
    a training view, the coarse N_samples and the fine z-union of N_samples +
    N_importance), K4 and K3 on the middle N_test chunk of the first test
    view, and, where the config is edited, K5 on that chunk's fine z-union
    (what an edit's accumulated-label pass composites). Returns {kernel: max
    abs error}."""
    from dmnerf_torch.core.rays import get_rays
    from dmnerf_torch.core.sampling import sample_pdf, z_val_sample
    from dmnerf_torch.kernels import field as kf
    from dmnerf_torch.kernels import render_field as krf

    dev = torch.device("cuda")
    coarse, fine = params["coarse"], params["fine"]
    pc, pf = krf.pack_field(coarse), krf.pack_field(fine)
    H, W, K = scene.hwk
    rng = np.random.default_rng(14)

    def rays(i):
        ro, rd = get_rays(H, W, torch.as_tensor(K, dtype=torch.float32, device=dev),
                          torch.as_tensor(scene.poses[i], dtype=torch.float32, device=dev))
        return ro.reshape(-1, 3), rd.reshape(-1, 3)

    def fine_z(ro, rd, z_c):
        with torch.no_grad():
            w = krf.render_field_sigma_ref(coarse, ro[:, None] + rd[:, None] * z_c[..., None],
                                           z_c, rd)
        z_s = sample_pdf(0.5 * (z_c[:, 1:] + z_c[:, :-1]), w[:, 1:-1], args.N_importance,
                         det=True)
        return torch.sort(torch.cat([z_c, z_s], -1), -1)[0].contiguous(), w

    errs = {}
    ro, rd = rays(scene.i_train[0])
    pick = torch.as_tensor(rng.choice(H * W, args.N_train, replace=False), device=dev)
    ro, rd = ro[pick], rd[pick]
    vd = (rd / torch.linalg.norm(rd, dim=-1, keepdim=True))[:, None].contiguous()
    z_c = z_val_sample(args.N_train, args.near, args.far, args.N_samples, device=dev)
    for field, packed, z in ((coarse, pc, z_c), (fine, pf, fine_z(ro, rd, z_c)[0])):
        pts = ro[:, None] + rd[:, None] * z[..., None]
        g = torch.tensor(rng.normal(size=(pts.shape[0] * pts.shape[1], field.cfg.ins_num + 5))
                         * 1e-3, dtype=torch.float32, device=dev)
        e_raw, e_grad = check_field_kernels(
            (field, packed, pts, vd, *kf.flatten_inputs(pts, vd), g),
            f"{name} {args.N_train} rays x {z.shape[1]}", probe=False)
        errs["field_forward"] = max(errs.get("field_forward", 0.0), e_raw)
        errs["field_backward"] = max(errs.get("field_backward", 0.0), e_grad)

    ro, rd = rays(scene.i_test[0])
    s0 = (H * W // args.N_test // 2) * args.N_test
    ro, rd = ro[s0:s0 + args.N_test], rd[s0:s0 + args.N_test]
    vd = (rd / torch.linalg.norm(rd, dim=-1, keepdim=True))[:, None].contiguous()
    z_c = z_val_sample(args.N_test, args.near, args.far, args.N_samples, device=dev).contiguous()
    z_f, w_p = fine_z(ro, rd, z_c)
    pts_c = ro[:, None] + rd[:, None] * z_c[..., None]
    pts_f = ro[:, None] + rd[:, None] * z_f[..., None]
    label = f"{name} {args.N_test} rays of {H}x{W}"
    with torch.no_grad():
        w_k = krf.render_field_sigma(pc, pts_c, z_c, rd)
        all_k = krf.render_field_all(pf, pts_f, vd, z_f, rd)
        all_p = krf.render_field_all_ref(fine, pts_f, vd, z_f, rd)
        torch.cuda.synchronize()
        errs["render_field_sigma"] = check(f"render_field_sigma {label} x {z_c.shape[1]}",
                                           "weights", w_k, w_p, coarse.density(pts_c[:, -1])[..., 0])
        sig_f = fine.density(pts_f[:, -1])[..., 0]
        errs["render_field_all"] = max(
            check(f"render_field_all {label} x {z_f.shape[1]}", out, got, want, sig_f)
            for out, got, want in zip(("rgb", "depth", "ins_logits"), all_k, all_p))
        if edits:
            k5 = krf.render_field_ins(pf, pts_f, z_f, rd)
            errs["render_field_ins"] = check(
                f"render_field_ins {label} x {z_f.shape[1]}", "ins_logits", k5,
                krf.render_field_ins_ref(fine, pts_f, z_f, rd), sig_f)
            if not torch.equal(k5, all_k[2]):
                raise AssertionError(f"{name}: K5's logits differ from K3's")
    return errs


def reference_scenes(card, tmp):
    """Phase 14: the DM-SR and replica64 stress scenes written by
    dmnerf_torch.tools.make_stress_scenes at the tool's full sizes, loaded
    through load_dataset without imageio, h5py, cv2 or PIL, then
    dmsr_stress.txt trained (STRESS_STEPS steps), rendered, edited (eval,
    rigid demo, mixed demo) and meshed, and replica64_stress.txt trained and
    rendered, all through the CLIs with exact launch counts. After each
    training run, every kernel that the config's path launches is held
    against its plain version on the trained field at the config's shapes.
    The scenes, logs and checkpoints stay in `tmp` (phase 16 reads them).
    Returns ({kernel: launches of the phase}, {kernel: {config: max abs
    error}}, {CLI call: s/view})."""
    from dmnerf_torch.cli import test as cli_test
    from dmnerf_torch.cli import train as cli_train
    from dmnerf_torch.config import parse_args
    from dmnerf_torch.data.base import load_dataset
    from dmnerf_torch.mesh.ply import read_ply
    from dmnerf_torch.models.fields import FieldConfig
    from dmnerf_torch.tools import make_stress_scenes as mss

    phase(f"14 reference-format scenes: the DM-SR and replica64 stress scenes written and "
          f"loaded by the port, dmsr_stress.txt through train ({STRESS_STEPS} steps), render, "
          f"mani_eval, mani_demo and mesh, replica64_stress.txt through train and render (bf16)")
    totals, errs, per_view_secs = {}, {}, {}

    def run(what, want, fn):
        out, secs, launches = counted(what, want, fn)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        return out, secs

    class TimedRenderer(mss.Renderer):
        """The tool's GT renderer, adding up its seconds (render_gt returns
        host arrays, so each call ends synchronised)."""
        seconds = 0.0

        def __call__(self, *a):
            t = time.perf_counter()
            out = super().__call__(*a)
            self.seconds += time.perf_counter() - t
            return out

    for what, write in (("dmsr/stress (16 objects, 640x480, 48 + 4 views, 4 edited)",
                         lambda rend: mss.write_dmsr(tmp, rend)),
                        ("replica64/stress (64 objects, 120x160, 360 frames)",
                         lambda rend: mss.write_replica(tmp, rend, n_obj=64,
                                                        name="replica64"))):
        rend = TimedRenderer(torch.device("cuda"))
        t0 = time.perf_counter()
        write(rend)
        secs = time.perf_counter() - t0
        print(f"make_stress_scenes {what}: {secs:.2f} s, of which GT renders "
              f"{rend.seconds:.2f} s and the rest (the PNG writes, with the JSON, pose "
              f"and HDF5 files) {secs - rend.seconds:.2f} s ({card})")

    runs = {"dmsr": ("configs/stress/dmsr_stress.txt", os.path.join(tmp, "dmsr", "stress")),
            "replica64": ("configs/stress/replica64_stress.txt",
                          os.path.join(tmp, "replica64", "stress"))}
    scenes = {}
    for name, (cfg, datadir) in runs.items():
        args = parse_args(["--config", os.path.join(REPO, cfg), "--datadir", datadir])
        args.is_train = True
        t0 = time.perf_counter()
        scene = load_dataset(args)
        args.ins_num = scene.ins_num
        scenes[name] = (args, scene)
        print(f"load_dataset {name}: {len(scene.images)} images {scene.H}x{scene.W}, "
              f"ins_num {scene.ins_num}, in {time.perf_counter() - t0:.2f} s")
    if banned_modules():
        raise AssertionError(f"the readers loaded {banned_modules()}")

    def cli_args(name, *flags):
        cfg, datadir = runs[name]
        return ["--config", os.path.join(REPO, cfg), "--datadir", datadir,
                "--basedir", os.path.join(tmp, "logs"), *flags, "--device", "cuda"]

    def train(name, edits):
        args, scene = scenes[name]
        _, secs = run(f"cli.train {name}, {STRESS_STEPS} steps", {
            "field_forward": 2 * STRESS_STEPS, "field_backward": 2 * STRESS_STEPS},
            lambda: cli_train.main(cli_args(name, "--n_iters", str(STRESS_STEPS - 1),
                                            "--i_print", "10")))
        ldir = os.path.join(tmp, "logs", f"{name}_stress", "drill")
        lines = [json.loads(l) for l in open(os.path.join(ldir, "metrics.jsonl"))]
        if len(lines) != STRESS_STEPS // 10 or not np.isfinite(
                [l[k] for l in lines for k in ("total_loss", "psnr_fine")]).all():
            raise AssertionError(f"cli.train {name}: metrics {lines[-1]}")
        ms = np.mean([1e3 * args.N_train / l["rays_per_sec"] for l in lines[1:]])
        print(f"cli.train {name}: {ms:.2f} ms/step after its first 10 steps, "
              f"{secs:.1f} s in all (the scene's load included); last {lines[-1]} ({card})")
        params, _ = cli_test.load_fields(cli_test.latest_tar(ldir),
                                         FieldConfig.from_args(args), torch.device("cuda"))
        for k, e in stress_kernels_vs_plain(name, args, scene, params, edits).items():
            errs.setdefault(k, {})[name] = e

    def per_view(what, secs, views):
        per_view_secs[what] = secs / views
        print(f"{what}: {secs / views:.3f} s/view over {views} views (the whole CLI call "
              f"over the views: the scene's load and the checkpoint included; {card})")

    def results(savedir, what, n):
        table = np.loadtxt(os.path.join(savedir, "test_results.txt"))
        if table.shape != (n + 1, 9) or not np.isfinite(table[:, 0]).all():
            raise AssertionError(f"{what}: test_results.txt {table.shape}, PSNR {table[:, 0]}")
        print(f"{what}: test_results.txt mean row PSNR {table[-1, 0]:.4f} SSIM "
              f"{table[-1, 1]:.4f} AP50 {table[-1, 3]:.4f}")

    def render(name, views, chunks):
        what = f"cli.test --render {name}"
        savedir, secs = run(f"{what}, {views} views", {
            "render_field_sigma": views * chunks, "render_field_all": views * chunks},
            lambda: cli_test.main(cli_args(name, "--render")))
        per_view(what, secs, views)
        results(savedir, what, views)

    chunks = -(-640 * 480 // 4096)
    resolve = 3 * chunks            # resolve_target_label renders 3 test views
    train("dmsr", edits=True)
    render("dmsr", 4, chunks)

    want = {"field_forward": 4 * chunks * 2 * 2, "render_field_ins": 4 * chunks * 2,
            "render_field_sigma": resolve, "render_field_all": resolve}
    savedir, secs = run("cli.test --mani_eval dmsr, 4 views, 1 object", want,
                        lambda: cli_test.main(cli_args("dmsr", "--mani_eval")))
    per_view("cli.test --mani_eval dmsr (after a 3-view resolve render)", secs, 4)
    results(os.path.join(savedir, "translation"), "cli.test --mani_eval dmsr", 4)
    for mani_type, n_obj in (("rigid", 1), ("deform", 2)):
        what = f"cli.test --mani_demo --mani_type {mani_type} dmsr"
        want = {"field_forward": 2 * chunks * 2 * (1 + n_obj),
                "render_field_ins": 2 * chunks * (1 + n_obj),
                "render_field_sigma": resolve, "render_field_all": resolve}
        savedir, secs = run(f"{what}, 2 views, {n_obj} object(s)", want, lambda: cli_test.main(
            cli_args("dmsr", "--mani_demo", "--mani_type", mani_type, "--views", "2")))
        per_view(f"{what} (after a 3-view resolve render)", secs, 2)
        names = sorted(os.listdir(os.path.join(savedir, mani_type)))
        if names != sorted(f"{i}_{k}.png" for i in range(2)
                           for k in ("rgb", "ins", "ins_pred_mask")):
            raise AssertionError(f"--mani_demo {mani_type} wrote {names}")

    # the mesh: K1 on the 192^3 grid, then K4 + K3 on the vertex rays
    from dmnerf_torch.mesh import extract

    def mesh():
        ply = os.path.join(cli_test.main(cli_args("dmsr", "--mesh")),
                           "color_dmsr_stress.ply")
        if not os.path.exists(ply):
            raise AssertionError(f"cli.test --mesh dmsr wrote no {ply} (an empty isosurface)")
        return tuple(len(a) for a in read_ply(ply))
    (V, F), secs = run("cli.test --mesh dmsr (grid 192, extents 13,13,13)", lambda vf: {
        "field_forward": -(-192 ** 3 // extract.DENSITY_BATCH),
        "render_field_sigma": -(-vf[0] // 4096), "render_field_all": -(-vf[0] // 4096)},
        mesh)
    print(f"cli.test --mesh dmsr: V {V}, F {F} after cleanup, {secs:.1f} s in all (the "
          f"scene's load and the checkpoint included; {card})")
    if V == 0 or F == 0:
        raise AssertionError(f"cli.test --mesh dmsr: an empty mesh (V {V}, F {F})")

    train("replica64", edits=False)
    views = len(range(0, 180, 8))          # replica64_stress.txt's testskip 8
    render("replica64", views, -(-120 * 160 // 4096))
    if banned_modules():
        raise AssertionError(f"phase 14 loaded {banned_modules()}")
    for k, n in totals.items():
        print(f"phase 14 {k}: {n} launches; against its plain version at the stress "
              f"configs' shapes, max abs err {errs.get(k)}")
    return totals, errs, per_view_secs


# the JPEG fixtures and their checker, jpeg_fixtures.py
JPEG_GOLDEN = os.path.join(REPO, "tests", "torch_golden", "jpeg")
# phase 15(c): frames of the written .sens, and the flagship's training steps
SENS_FRAMES = 40
SCANNET_STEPS = 30
# ScanNet's frame sizes: colour 1296x968 (JPEG), depth and labels 640x480
COLOR_HW, DEPTH_HW = (968, 1296), (480, 640)
# scannetv2-labels.combined.tsv's columns; rows: raw id, category, nyu40 id
TSV_COLUMNS = ("id", "raw_category", "category", "count", "nyu40id", "eigen13id",
               "nyuClass", "nyu40class", "eigen13class", "ModelNet40", "ModelNet",
               "synsetoffset", "wnsynsetid", "wnsynsetkey", "mpcat40index", "mpcat40")
TSV_ROWS = ((1, "wall", 1), (2, "chair", 5), (3, "floor", 2), (4, "table", 7),
            (6, "couch", 6), (7, "cabinet", 3), (9, "desk", 14), (11, "bed", 4),
            (15, "picture", 11), (16, "window", 9), (17, "toilet", 33))


def write_raw_scannet(root, scene, objs, card, device="cuda"):
    """A raw ScanNet scene as the preprocessing reads it: scans/{scene}/
    {scene}.sens (version 4, SENS_FRAMES frames: 1296x968 JPEG colour by
    write_jpeg from the card's GT march, 640x480 zlib uint16 depth, the
    depth intrinsics of 640x480), out/{scene}/label-filt/{i}.png (raw ids,
    uint16) and instance-filt/{i}.png (uint8) at 640x480, and a label-map
    TSV in scannetv2-labels.combined.tsv's columns. Returns the TSV's path."""
    from dmnerf_torch.data.procedural import render_gt
    from dmnerf_torch.data.scannet import nearest_index
    from dmnerf_torch.data.scannet_preprocess.sensordata import write_sens
    from dmnerf_torch.edit.transforms import pose_spherical
    from dmnerf_torch.utils.jpeg import encode_jpeg
    from dmnerf_torch.utils.png import write_png

    (cH, cW), (dH, dW) = COLOR_HW, DEPTH_HW
    Kc = np.eye(4)
    Kc[0, 0], Kc[1, 1], Kc[0, 2], Kc[1, 2] = 0.9 * cW, 0.9 * cW, cW / 2, cH / 2
    Kd = np.diag([dW / cW, dH / cH, 1.0, 1.0]) @ Kc
    rows, cols = nearest_index(cH, dH), nearest_index(cW, dW)
    raw_ids = [r[0] for r in TSV_ROWS[1:] if r[2] != 2]     # objects: not wall or floor
    labels = os.path.join(root, "out", scene)
    for sub in ("label-filt", "instance-filt"):
        os.makedirs(os.path.join(labels, sub), exist_ok=True)
    colors, depths, poses = [], [], []
    t_gt = t_enc = 0.0
    for i in range(SENS_FRAMES):
        cv = np.array(pose_spherical(i * 360.0 / SENS_FRAMES, -22.0 - 9.0 * (i % 3), 4.1))
        cv[:3, :3] = cv[:3, :3] @ np.diag([1.0, -1.0, -1.0])
        t = time.perf_counter()
        img, lab = render_gt(cv, cH, cW, Kc[:3, :3], 1.0, 14.0, objs, n_samples=96,
                             device=torch.device(device))
        t_gt += time.perf_counter() - t
        t = time.perf_counter()
        colors.append(encode_jpeg((255 * np.clip(img, 0, 1)).astype(np.uint8)))
        t_enc += time.perf_counter() - t
        lab = lab[rows][:, cols]
        sem = np.array([1] + [raw_ids[k % len(raw_ids)] for k in range(len(objs))],
                       np.uint16)[lab]
        write_png(os.path.join(labels, "label-filt", f"{i}.png"), sem)
        write_png(os.path.join(labels, "instance-filt", f"{i}.png"), lab.astype(np.uint8))
        depths.append((1000 + 250 * lab).astype(np.uint16))
        poses.append(cv)
    os.makedirs(os.path.join(root, "scans", scene), exist_ok=True)
    sens = os.path.join(root, "scans", scene, f"{scene}.sens")
    write_sens(sens, colors, depths, poses, Kc, Kd)
    tsv = os.path.join(root, "scannetv2-labels.combined.tsv")
    with open(tsv, "w") as f:
        f.write("\t".join(TSV_COLUMNS) + "\n")
        for rid, name, nyu40 in TSV_ROWS:
            f.write("\t".join([str(rid), name, name, "1", str(nyu40)] + [""] * 11) + "\n")
    print(f"raw {scene}: {SENS_FRAMES} frames, GT march {t_gt:.2f} s ({cW}x{cH}, 96 samples), "
          f"write_jpeg {1e3 * t_enc / SENS_FRAMES:.1f} ms/frame, .sens "
          f"{os.path.getsize(sens) / 2 ** 20:.1f} MiB ({card})")
    return tsv


def scannet_slice(card):
    """Phase 15: (a) the JPEG codec on its fixtures and its ms per 968x1296
    frame; (b) make_stress_scenes --only scannet on the card, load_dataset,
    scannet_stress.txt through cli.train (STRESS_STEPS steps) and cli.test
    --render (3 views), K1/K2/K4/K3 against their plain versions on the
    trained field; (c) a raw ScanNet scene (a .sens of 1296x968 JPEG frames,
    label PNGs, a TSV) through `python -m dmnerf_torch.data.scannet_preprocess.run`,
    then the flagship configs/scannet/{train,test}/scene0010_00.txt through
    cli.train (SCANNET_STEPS steps), K1/K2/K4/K3 against their plain versions
    on that trained field at its shapes, and cli.test --render. Exact
    launches everywhere. Returns ({kernel: launches}, {kernel: {config: max abs err}})."""
    from dmnerf_torch import native
    from dmnerf_torch.cli import test as cli_test
    from dmnerf_torch.cli import train as cli_train
    from dmnerf_torch.config import parse_args
    from dmnerf_torch.data.base import load_dataset
    from dmnerf_torch.data.procedural import make_objects, palette
    from dmnerf_torch.models.fields import FieldConfig
    from dmnerf_torch.tools import make_stress_scenes as mss
    from dmnerf_torch.utils.hdf5 import write_dataset
    from dmnerf_torch.utils.jpeg import encode_jpeg, read_jpeg
    sys.path.insert(0, JPEG_GOLDEN)
    from jpeg_fixtures import jpeg_golden, smooth_frame

    phase(f"15 ScanNet: the JPEG codec on its fixtures; scannet_stress.txt written, loaded, "
          f"trained ({STRESS_STEPS} steps) and rendered; a raw 1296x968 .sens through the "
          f"preprocessing, then scene0010_00.txt (8x256) trained ({SCANNET_STEPS} steps) and "
          f"rendered (bf16)")
    t_phase = time.perf_counter()
    totals, errs = {}, {}

    def run(what, want, fn):
        out, secs, launches = counted(what, want, fn)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        return out, secs

    # (a) the codec
    t0 = time.perf_counter()
    native.require("_jpeg_native", "jpeg.cpp")
    print(f"15a built dmnerf_torch/native/jpeg.cpp with g++ in {time.perf_counter() - t0:.2f} s")
    n_dec, n_enc = jpeg_golden()
    print(f"15a JPEG fixtures: {n_dec} files decoded to Pillow's arrays and {n_enc} sources "
          f"encoded to imageio's bytes, exactly")
    frame = smooth_frame(*COLOR_HW)
    data = encode_jpeg(frame)
    for what, fn in (("decode", lambda: read_jpeg(data)), ("encode", lambda: encode_jpeg(frame))):
        fn()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        print(f"15a {what} of a {COLOR_HW[1]}x{COLOR_HW[0]} frame: "
              f"{100 * (time.perf_counter() - t0):.2f} ms (host, one thread; {card})")

    def trained(what, ldir, args, steps):
        lines = [json.loads(l) for l in open(os.path.join(ldir, "metrics.jsonl"))]
        if len(lines) != steps // 10 or not np.isfinite(
                [l[k] for l in lines for k in ("total_loss", "psnr_fine")]).all():
            raise AssertionError(f"cli.train {what}: metrics {lines[-1]}")
        ms = np.mean([1e3 * args.N_train / l["rays_per_sec"] for l in lines[1:]])
        print(f"cli.train {what}: {ms:.2f} ms/step after its first 10 steps; last "
              f"{lines[-1]} ({card})")

    def rendered(what, savedir, secs, views):
        table = np.loadtxt(os.path.join(savedir, "test_results.txt"))
        if table.shape != (views + 1, 9) or not np.isfinite(table[:, 0]).all():
            raise AssertionError(f"{what}: test_results.txt {table.shape}, PSNR {table[:, 0]}")
        print(f"{what}: {secs / views:.3f} s/view over {views} views (the whole CLI call; "
              f"{card}); mean PSNR {table[-1, 0]:.4f} SSIM {table[-1, 1]:.4f} AP50 "
              f"{table[-1, 3]:.4f}")

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the stress scene and its config
        t0 = time.perf_counter()
        mss.main(["--out", tmp, "--only", "scannet"])
        print(f"15b make_stress_scenes --only scannet (16 objects, 480x640, 20 + 3 views): "
              f"{time.perf_counter() - t0:.2f} s ({card})")
        cfg = os.path.join(REPO, "configs", "stress", "scannet_stress.txt")
        datadir = os.path.join(tmp, "scannet", "stress")
        args = parse_args(["--config", cfg, "--datadir", datadir])
        args.is_train = True
        t0 = time.perf_counter()
        scene = load_dataset(args)
        args.ins_num = scene.ins_num
        print(f"15b load_dataset scannet/stress: {len(scene.images)} images {scene.H}x{scene.W}, "
              f"ins_num {scene.ins_num}, in {time.perf_counter() - t0:.2f} s")
        if banned_modules():
            raise AssertionError(f"the ScanNet reader loaded {banned_modules()}")
        flags = ["--config", cfg, "--datadir", datadir, "--basedir",
                 os.path.join(tmp, "logs"), "--device", "cuda"]
        run(f"cli.train scannet_stress, {STRESS_STEPS} steps",
            {"field_forward": 2 * STRESS_STEPS, "field_backward": 2 * STRESS_STEPS},
            lambda: cli_train.main(flags + ["--n_iters", str(STRESS_STEPS - 1), "--i_print", "10"]))
        ldir = os.path.join(tmp, "logs", "scannet_stress", "drill")
        trained("scannet_stress", ldir, args, STRESS_STEPS)
        params, _ = cli_test.load_fields(cli_test.latest_tar(ldir), FieldConfig.from_args(args),
                                         torch.device("cuda"))
        for k, e in stress_kernels_vs_plain("scannet", args, scene, params, False).items():
            errs.setdefault(k, {})["scannet"] = e
        chunks = -(-scene.H * scene.W // args.N_test)
        views = len(scene.i_test)
        savedir, secs = run(f"cli.test --render scannet_stress, {views} views", {
            "render_field_sigma": views * chunks, "render_field_all": views * chunks},
            lambda: cli_test.main(flags + ["--render"]))
        rendered("cli.test --render scannet_stress", savedir, secs, views)

        # (c) raw ScanNet to a trained flagship
        # a name of its own: data/color_dict.json's palette map of the real
        # scene0010_00 does not fit this scene's labels
        scene_name = "scene9999_00"
        root = os.path.join(tmp, "raw")
        objs = make_objects(7, seed=10)     # as many objects as scene0010_00 has instances
        tsv = write_raw_scannet(root, scene_name, objs, card)
        save_dir = os.path.join(tmp, "scannet")
        proc = subprocess.run(
            [sys.executable, "-m", "dmnerf_torch.data.scannet_preprocess.run",
             "--scans", os.path.join(root, "scans"), "--out", os.path.join(root, "out"),
             "--label_map", tsv, "--save_dir", save_dir], cwd=REPO, capture_output=True,
            text=True, timeout=600)
        print(proc.stdout.strip())
        if proc.returncode:
            raise AssertionError(f"scannet_preprocess.run failed: {proc.stderr[-2000:]}")
        secs = {k: float(v) for k, v in re.findall(
            r"^(exported|remapped|split) .* in ([0-9.]+) s$", proc.stdout, re.M)}
        print(f"15c preprocessing ({card}): export {1e3 * secs['exported'] / SENS_FRAMES:.1f} "
              f"ms/frame (decode, encode, depth PNG, pose), label remap "
              f"{1e3 * secs['remapped'] / SENS_FRAMES:.1f} ms/frame, split "
              f"{secs['split']:.3f} s")
        datadir = os.path.join(save_dir, scene_name)
        ins_num = max(int(np.load(os.path.join(datadir, split, f"{split}_ins", f))[
            "ins_2d_label_id"].max()) for split in ("train", "test")
            for f in os.listdir(os.path.join(datadir, split, f"{split}_ins"))) + 1
        write_dataset(os.path.join(datadir, "ins_rgb.hdf5"), "datasets", palette(ins_num + 1)[1:])
        cfgs = {k: os.path.join(REPO, "configs", "scannet", k, "scene0010_00.txt")
                for k in ("train", "test")}
        args = parse_args(["--config", cfgs["train"], "--datadir", datadir])
        args.is_train = True
        t0 = time.perf_counter()
        scene = load_dataset(args)
        secs = time.perf_counter() - t0
        args.ins_num = scene.ins_num
        print(f"15c load_dataset {scene_name} (resize): {len(scene.images)} frames "
              f"{scene.H}x{scene.W}, ins_num {scene.ins_num}, {1e3 * secs / len(scene.images):.1f} "
              f"ms/frame ({card})")
        if (scene.H, scene.W) != DEPTH_HW or scene.ins_num < 2:
            raise AssertionError(f"{scene_name}: {scene.H}x{scene.W}, ins_num {scene.ins_num}")
        flags = ["--datadir", datadir, "--basedir", os.path.join(tmp, "logs"),
                 "--log_time", "smoke", "--device", "cuda"]
        run(f"cli.train {scene_name}, {SCANNET_STEPS} steps",
            {"field_forward": 2 * SCANNET_STEPS, "field_backward": 2 * SCANNET_STEPS},
            lambda: cli_train.main(["--config", cfgs["train"], *flags, "--n_iters",
                                    str(SCANNET_STEPS - 1), "--i_print", "10"]))
        ldir = os.path.join(tmp, "logs", "scene0010_00", "smoke")
        trained(scene_name, ldir, args, SCANNET_STEPS)
        params, _ = cli_test.load_fields(cli_test.latest_tar(ldir), FieldConfig.from_args(args),
                                         torch.device("cuda"))
        for k, e in stress_kernels_vs_plain("scene0010_00", args, scene, params, False).items():
            errs.setdefault(k, {})["scene0010_00"] = e
        skip = 8
        views = len(range(0, len(scene.i_test), skip))
        chunks = -(-scene.H * scene.W // args.N_test)
        savedir, secs = run(f"cli.test --render {scene_name}, {views} views", {
            "render_field_sigma": views * chunks, "render_field_all": views * chunks},
            lambda: cli_test.main(["--config", cfgs["test"], *flags, "--render",
                                   "--testskip", str(skip)]))
        rendered(f"cli.test --render {scene_name}", savedir, secs, views)
    if banned_modules():
        raise AssertionError(f"phase 15 loaded {banned_modules()}")
    for k, n in totals.items():
        print(f"phase 15 {k}: {n} launches; against its plain version at scannet_stress's "
              f"and scene0010_00's shapes, max abs err {errs.get(k)}")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return totals, errs


# phase 16: the random LPIPS weights' seed and the bar of the card against the
# CPU (both fp32, TF32 off: only the order of the convolutions' sums differs)
LPIPS_SEED = 0
LPIPS_TOL = 1e-4
# phase 16(c): cli.train for PROFILE_ITERS steps in dispatches of PROFILE_SCAN,
# of which PROFILE_STEPS after the first are traced, on a scene that is quick
# to make and has more pixels than the 3072 rays of a step; (d): the steps of
# trace_step's traced dispatch (its default is 50: a shorter trace writes and
# parses faster)
PROFILE_ITERS, PROFILE_SCAN, PROFILE_STEPS = 20, 5, 2
PROFILE_SCENE = "./data/synthetic/boxroom64x4"
CAPTURE_STEPS = 20


def lpips_flops(H, W):
    """Multiply-adds x 2 of LPIPS-VGG's 13 convolutions on one H x W image."""
    from dmnerf_torch.eval.lpips import _VGG_CFG
    flops, cin = 0, 3
    for item in _VGG_CFG:
        if item == "M":
            H, W = H // 2, W // 2
        else:
            flops += 2 * 9 * cin * item * H * W
            cin = item
    return flops


def lpips_and_trace(card, tmp, phase14_secs):
    """Phase 16: (a) LPIPS (random weights in the .npz layout) on the card
    against the CPU on a 480x640 pair and its 432x576 ScanNet-sized crop,
    normalize False and True, within LPIPS_TOL of max(1, |CPU|), the TF32-on
    difference beside it (a finding only) and ms per call; (b) cli.test
    --render and --mani_eval with --lpips_weights on phase 14's trained
    dmsr_stress field in `tmp` (finite LPIPS column and mean, s/view against
    phase 14's calls without LPIPS, exact launches); (c) cli.train --profile_steps
    on the flagship: the trace's K1/K2 launches exact, device events present,
    metrics.jsonl equal to the untraced run's but for rays_per_sec; (d)
    `python -m dmnerf_torch.tools.trace_step` capturing bench.py's train
    workload. Returns {kernel: launches of the phase}."""
    from dmnerf_torch.cli import test as cli_test
    from dmnerf_torch.cli import train as cli_train
    from dmnerf_torch.eval import lpips
    from dmnerf_torch.tools import trace_step

    phase("16 LPIPS and the trace: LPIPS on the card against the CPU; cli.test --render and "
          "--mani_eval with --lpips_weights on the dmsr_stress field; cli.train --profile_steps "
          "and trace_step's reader; trace_step capturing bench.py's train workload")
    t_phase = time.perf_counter()
    totals = {}

    def run(what, want, fn):
        out, secs, launches = counted(what, want, fn)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        return out, secs

    # (a) the card against the CPU
    weights = os.path.join(tmp, "lpips_random.npz")
    arrays = lpips.random_weights(LPIPS_SEED)
    np.savez(weights, **arrays)
    rng = np.random.default_rng(16)
    a = rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    pairs = {"480x640": (a, b), "432x576 crop": (a[24:456, 32:608], b[24:456, 32:608])}
    on_card = lpips.prepare_params(arrays, "cuda")

    @contextlib.contextmanager
    def tf32():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    for normalize in (False, True):
        card_fn = lpips.load_lpips(weights, normalize, device="cuda")
        cpu_fn = lpips.load_lpips(weights, normalize, device="cpu")
        for name, (x, y) in pairs.items():
            want, got = cpu_fn(x, y), card_fn(x, y)
            saved, lpips._cudnn_fp32 = lpips._cudnn_fp32, tf32
            try:
                got_tf32 = float(lpips.lpips_distance(on_card, torch.from_numpy(x).cuda(),
                                                      torch.from_numpy(y).cuda(), normalize))
            finally:
                lpips._cudnn_fp32 = saved
            ms = cuda_ms(lambda: card_fn(x, y), reps=5, warmup=1)
            bound = 2 * lpips_flops(*x.shape[:2]) / PEAK_FP32_FLOPS * 1e3
            err, bar = abs(got - want), LPIPS_TOL * max(1.0, abs(want))
            print(f"LPIPS {name}, normalize {normalize}: card {got:.9f}, CPU {want:.9f}, "
                  f"|card - CPU| {err:.3e} (bar {bar:.1e}); TF32 on: |card - CPU| "
                  f"{abs(got_tf32 - want):.3e} (a finding only); {ms:.3f} ms per call "
                  f"(median of 5, the host->device copy and the read-back included; fp32 "
                  f"bound {bound:.3f} ms, {2 * lpips_flops(*x.shape[:2]) / 1e9:.1f} GFLOP; "
                  f"{card})")
            if not np.isfinite(got) or err > bar:
                raise AssertionError(f"LPIPS {name} normalize {normalize}: card {got} against "
                                     f"the CPU's {want}")

    # (b) the CLIs with LPIPS on phase 14's trained dmsr_stress field
    def cli_args(*flags):
        return ["--config", os.path.join(REPO, "configs/stress/dmsr_stress.txt"),
                "--datadir", os.path.join(tmp, "dmsr", "stress"),
                "--basedir", os.path.join(tmp, "logs"), "--lpips_weights", weights, *flags,
                "--device", "cuda"]

    def lpips_column(savedir, what, secs, n, before):
        table = np.loadtxt(os.path.join(savedir, "test_results.txt"))
        if table.shape != (n + 1, 9) or not np.isfinite(table[:, 2]).all():
            raise AssertionError(f"{what}: test_results.txt {table.shape}, LPIPS {table[:, 2]}")
        print(f"{what}: LPIPS per view {table[:-1, 2]}, mean {table[-1, 2]:.6f}; {secs / n:.3f} "
              f"s/view against {before:.3f} without LPIPS (phase 14; the whole CLI call over "
              f"its views; {card})")

    chunks = -(-640 * 480 // 4096)
    resolve = 3 * chunks
    what = "cli.test --render dmsr --lpips_weights"
    savedir, secs = run(f"{what}, 4 views", {"render_field_sigma": 4 * chunks,
                                            "render_field_all": 4 * chunks},
                        lambda: cli_test.main(cli_args("--render")))
    lpips_column(savedir, what, secs, 4, phase14_secs["cli.test --render dmsr"])
    what = "cli.test --mani_eval dmsr --lpips_weights"
    savedir, secs = run(f"{what}, 4 views, 1 object", {
        "field_forward": 4 * chunks * 2 * 2, "render_field_ins": 4 * chunks * 2,
        "render_field_sigma": resolve, "render_field_all": resolve},
        lambda: cli_test.main(cli_args("--mani_eval")))
    lpips_column(os.path.join(savedir, "translation"), what, secs, 4,
                 phase14_secs["cli.test --mani_eval dmsr (after a 3-view resolve render)"])

    with tempfile.TemporaryDirectory() as ptmp:
        # (c) --profile_steps through the train CLI, against the same run untraced
        n_traced = PROFILE_STEPS * PROFILE_SCAN
        rows = {}
        for name, extra in (("untraced", []), ("traced", ["--profile_steps",
                                                          str(PROFILE_STEPS)])):
            cfg = train_cfg(ptmp, name, PROFILE_ITERS - 1, ["i_print = 5", "i_save = 20",
                                                           "i_test = 0"])
            run(f"cli.train {name}, {PROFILE_ITERS} steps in dispatches of {PROFILE_SCAN}",
                {"field_forward": 2 * PROFILE_ITERS, "field_backward": 2 * PROFILE_ITERS},
                lambda: cli_train.main(["--config", cfg, "--datadir", PROFILE_SCENE,
                                        "--scan_steps", str(PROFILE_SCAN), "--device", "cuda",
                                        *extra]))
            rows[name] = [{k: v for k, v in json.loads(line).items() if k != "rays_per_sec"}
                          for line in open(os.path.join(ptmp, name, "run", "metrics.jsonl"))]
        if rows["traced"] != rows["untraced"] or len(rows["traced"]) != PROFILE_ITERS // 5:
            raise AssertionError(f"--profile_steps moved the metrics: {rows}")
        prof = os.path.join(ptmp, "traced", "run", "profile")
        proc = subprocess.run([sys.executable, "-m", "dmnerf_torch.tools.trace_step",
                               "--parse_only", "--out", prof, "--steps", str(n_traced),
                               "--top", "12"], cwd=REPO, capture_output=True, text=True,
                              timeout=300)
        print(proc.stdout + proc.stderr)
        s = trace_step.summarize(trace_step.load_trace(trace_step.newest_trace(prof)))
        want = {"field_forward": 2 * n_traced, "field_backward": 2 * n_traced}
        if proc.returncode or not s["by_category"] or s["launches"] != want:
            raise AssertionError(f"the --profile_steps trace: rc {proc.returncode}, launches "
                                 f"{s['launches']}, expected {want}")
        print(f"cli.train --profile_steps {PROFILE_STEPS} --scan_steps {PROFILE_SCAN}: "
              f"{os.path.getsize(trace_step.newest_trace(prof)) / 2**20:.1f} MiB of trace, "
              f"launches in it {s['launches']}, metrics equal to the untraced run's")

        # (d) the bench train step through trace_step's capture
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "dmnerf_torch.tools.trace_step",
                               "--out", os.path.join(ptmp, "bench"), "--steps",
                               str(CAPTURE_STEPS), "--top", "25"],
                              cwd=REPO, capture_output=True, text=True, timeout=600)
        print(proc.stdout + proc.stderr)
        if proc.returncode:
            raise AssertionError(f"trace_step's capture failed with rc {proc.returncode}")
        print(f"trace_step capture: {time.perf_counter() - t0:.1f} s in all ({card})")
    if banned_modules():
        raise AssertionError(f"phase 16 loaded {banned_modules()}")
    print(f"phase 16: launches {totals}; {time.perf_counter() - t_phase:.1f} s")
    return totals


RANK_STEPS = 5
RANK_TIMEOUT = 300


def launches_now():
    from dmnerf_torch.kernels import field as kf
    from dmnerf_torch.kernels import render_field as krf
    return {k: v for k, v in {**kf.LAUNCHES, **krf.LAUNCHES}.items() if v}


def reset_all_launches():
    from dmnerf_torch.kernels import field as kf
    from dmnerf_torch.kernels import render_field as krf
    kf.reset_launches()
    krf.reset_launches()


def add_launches(total, more):
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def mesh_work(mesh, dev):
    """Phase 17(b)'s work on one rank of `mesh`, or alone (mesh None):
    RANK_STEPS steps of bench.py's train workload from seed 0, then a 128x128
    render and a 1-object rigid edit (N_test 4096) of a fresh seed-0 pair.
    Returns the first step's raws (this rank's rows) and gradients, the last
    metrics and parameters, the render and the edit on the host, and the
    launches of each part."""
    import copy

    from dmnerf_torch.edit.manipulator import make_pose_image_manipulator
    from dmnerf_torch.eval.renderer import make_image_renderer
    from dmnerf_torch.tools.trace_step import bench_workload
    from dmnerf_torch.train import step as step_mod

    args, scene, cfg = bench_workload()
    state = step_mod.create_train_state(0, cfg, args.lrate, args.lrate_decay, device=dev)
    fresh = copy.deepcopy(state.params)
    scan = step_mod.make_train_scan_step(args, cfg, mesh=mesh)
    arrs = step_mod.scene_arrays(scene, dev)
    out = {"launches": {}}

    def counted_part(name, fn):
        reset_all_launches()
        res = fn()
        torch.cuda.synchronize()
        out["launches"][name] = launches_now()
        return res

    raws, real = [], step_mod.render_rays

    def capture(*a, **k):
        o = real(*a, **k)
        raws.append((o["raw_coarse"].detach().cpu(), o["raw_fine"].detach().cpu()))
        return o

    step_mod.render_rays = capture
    try:
        counted_part("train step 1", lambda: scan(state, arrs, 1, np.arange(4), 1))
    finally:
        step_mod.render_rays = real
    out["raws"] = raws[0]
    out["grads"] = [p.grad.cpu() for g in state.opt.param_groups for p in g["params"]]
    m = counted_part(f"train steps 2-{RANK_STEPS}",
                     lambda: scan(state, arrs, 1, np.arange(4), RANK_STEPS - 1))
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["params"] = [p.detach().cpu() for g in state.opt.param_groups for p in g["params"]]

    bench = SimpleNamespace(N_test=4096, N_samples=64, N_importance=128, near=1.0, far=12.0)
    K = np.array([[0.7 * 128, 0, 64], [0, -0.7 * 128, 64], [0, 0, -1.0]], np.float32)
    pose = look_at_poses(1)[0].astype(np.float64)
    out["render"] = counted_part("render 128x128", lambda: make_image_renderer(
        cfg, bench, 128, 128, device=dev, use_pallas=True, mesh=mesh)(fresh, K, pose))
    run = make_pose_image_manipulator(cfg, fresh, bench, [{"mode": "rigid"}], [1], 128, 128,
                                      K, device=dev, use_pallas=True, mesh=mesh)
    out["edit"] = counted_part("edit 128x128, 1 object", lambda: tuple(
        t[:128 * 128].cpu().numpy() for t in run(pose, (translation(0.3) @ pose)[None],
                                                 np.zeros(1))))
    return out


def rank_main(argv):
    """A rank of phase 17 or 18, started by it: `cli OUT train|test CLI-ARGS`
    (under torchrun) runs that CLI and writes its launches to
    OUT.rank{r}.json; `mesh OUT` joins the two-rank group on cuda:0 over gloo
    and writes mesh_work's result to OUT/rank{r}.pt; `grid1 OUT` and `grid4
    OUT` (under torchrun) write grid_rank's result to OUT/grid{1,4}.rank{r}.pt."""
    from dmnerf_torch.parallel.mesh import close_mesh, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    what, out = argv[:2]
    rank = int(os.environ["RANK"])
    reset_all_launches()
    if what == "cli":
        from dmnerf_torch.cli import test as cli_test
        from dmnerf_torch.cli import train as cli_train
        {"train": cli_train, "test": cli_test}[argv[2]].main(argv[3:])
        torch.cuda.synchronize()
        with open(f"{out}.rank{rank}.json", "w") as f:
            json.dump(launches_now(), f)
    elif what == "mesh":
        mesh = make_mesh(0, "cuda:0", backend="gloo")
        torch.save(mesh_work(mesh, mesh.device), os.path.join(out, f"rank{rank}.pt"))
        close_mesh(mesh)
    else:
        torch.save(grid_rank(what, out), os.path.join(out, f"{what}.rank{rank}.pt"))
    return 0


class Children:
    """Processes started together, each writing its output to a file; wait()
    needs every one to exit 0 within RANK_TIMEOUT of its start, else it
    kills them all and fails the phase."""

    def __init__(self, cmds_envs, what, tmp):
        self.what, self.logs, self.t0 = what, [], time.perf_counter()
        self.procs = []
        for i, (cmd, env) in enumerate(cmds_envs):
            self.logs.append(os.path.join(tmp, f"{what.replace(' ', '_')}.{i}.log"))
            with open(self.logs[-1], "w") as log:
                self.procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                                   stderr=subprocess.STDOUT))
        CHILDREN.extend(self.procs)

    def wait(self):
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, RANK_TIMEOUT - (time.perf_counter() - self.t0)))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = [open(log).read() for log in self.logs]
        for i, (p, o) in enumerate(zip(self.procs, outs)):
            if p.returncode:
                raise AssertionError(f"{self.what}, process {i}: rc {p.returncode}\n{o[-4000:]}")
        return outs


def child_env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update({k: str(v) for k, v in kw.items()})
    return env


def same_tensors(a, b):
    """Bit-for-bit equality of two nested dicts / lists of tensors."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tensors(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def ray_mesh(dev, card):
    """Phase 17: the ray mesh (parallel/mesh.py) on the one card. The
    torchrun runs, the two gloo ranks and this process's one-process runs
    overlap; their checks follow. Returns the launches of the sharded runs,
    summed over the ranks."""
    import socket

    from dmnerf_torch.cli import test as cli_test
    from dmnerf_torch.cli import train as cli_train
    from dmnerf_torch.models.convert import load_tar

    phase("17 the ray mesh: (a) torchrun --nproc_per_node 1 (NCCL) of cli.train (30 steps, "
          "boxroom128x8, flagship) and cli.test --render against the same runs in this "
          f"process; (b) two ranks on cuda:0 over gloo: {RANK_STEPS} steps of bench.py's train "
          "workload (3072 rays, 64+128, 8x256 x2, K=32, penalizer and perturb), a 128x128 "
          "render and a 1-object edit, against one rank")
    t_phase = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        extra = ["i_print = 10", "i_save = 30", "i_test = 15"]
        cfgs = {name: train_cfg(tmp, name, 29, extra) for name in ("plain", "nccl")}
        views = 2 * (128 * 128 // 4096)        # the in-train eval's and the render's chunks
        want = {"train": {"field_forward": 60, "field_backward": 60,
                          "render_field_sigma": views, "render_field_all": views},
                "test": {"render_field_sigma": views, "render_field_all": views}}
        torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc_per_node", "1", os.path.join(REPO, "chip_smoke.py"), "--rank", "cli"]

        def start_torchrun(what, argv):
            return Children([(torchrun + [os.path.join(tmp, f"nccl_{what}"), what, "--config",
                                          cfgs["nccl"], *argv, "--device", "cuda"],
                              child_env())], f"torchrun cli.{what}", tmp)

        def check_torchrun(what, children):
            (log,) = children.wait()
            got = json.load(open(os.path.join(tmp, f"nccl_{what}.rank0.json")))
            print(f"(a) torchrun cli.{what}: {time.perf_counter() - children.t0:.1f} s; rank 0 "
                  f"launches {got}")
            if "rank 0 of 1 on cuda:0 (nccl)" not in log:
                raise AssertionError(f"torchrun cli.{what} joined no NCCL mesh:\n{log[-2000:]}")
            if got != want[what]:
                raise AssertionError(f"torchrun cli.{what}: launches {got}, expected "
                                     f"{want[what]}")
            add_launches(total, got)

        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        gloo = Children([([sys.executable, os.path.join(REPO, "chip_smoke.py"), "--rank", "mesh",
                           tmp], child_env(WORLD_SIZE=2, RANK=r, LOCAL_RANK=r,
                                           MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
                         for r in range(2)], "gloo rank", tmp)
        nccl_train = start_torchrun("train", [])
        counted("(a) cli.train in this process", want["train"],
                lambda: cli_train.main(["--config", cfgs["plain"], "--device", "cuda"]))
        counted("(a) cli.test --render in this process", want["test"],
                lambda: cli_test.main(["--config", cfgs["plain"], "--render", "--device", "cuda"]))
        check_torchrun("train", nccl_train)
        nccl_test = start_torchrun("test", ["--render"])
        reset_all_launches()
        t0 = time.perf_counter()
        ref = mesh_work(None, dev)
        print(f"(b) one rank in this process: {time.perf_counter() - t0:.1f} s")
        check_torchrun("test", nccl_test)
        gloo.wait()
        print(f"(b) two gloo ranks: {time.perf_counter() - gloo.t0:.1f} s")
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
               for r in range(2)]

        dirs = {n: os.path.join(tmp, n, "run") for n in cfgs}
        tars = [load_tar(os.path.join(d, "000030.tar"), with_optimizer=True)
                for d in dirs.values()]
        metrics = [[{k: v for k, v in json.loads(l).items() if k != "rays_per_sec"}
                    for l in open(os.path.join(d, "metrics.jsonl"))] for d in dirs.values()]
        outputs = {}
        for sub in ("testset_000015", "render_test_000030"):
            names = [sorted(os.listdir(os.path.join(d, sub))) for d in dirs.values()]
            outputs[sub] = names[0] == names[1] and all(
                open(os.path.join(dirs["plain"], sub, f), "rb").read()
                == open(os.path.join(dirs["nccl"], sub, f), "rb").read() for f in names[0])
        print(f"(a) NCCL world size 1 against one process: weights and Adam state "
              f"bit-identical {same_tensors(tars[0], tars[1])}, metrics.jsonl equal "
              f"{metrics[0] == metrics[1]}, the eval's and the render's files (pngs, "
              f"test_results.txt, matching_log.json) byte-identical {outputs}")
        print("render_test_000030/test_results.txt:\n"
              + open(os.path.join(dirs["nccl"], "render_test_000030", "test_results.txt")).read())
        if not (same_tensors(tars[0], tars[1]) and metrics[0] == metrics[1]
                and all(outputs.values())):
            raise AssertionError("torchrun at world size 1 differs from one process")

    per_rank_want = {
        "train step 1": {"field_forward": 2, "field_backward": 2},
        f"train steps 2-{RANK_STEPS}": {"field_forward": 2 * (RANK_STEPS - 1),
                                        "field_backward": 2 * (RANK_STEPS - 1)},
        "render 128x128": {"render_field_sigma": 4, "render_field_all": 4},
        "edit 128x128, 1 object": {"field_forward": 16, "render_field_ins": 8}}
    for r, g in enumerate(got):
        print(f"(b) rank {r} launches: {g['launches']}")
        if g["launches"] != per_rank_want:
            raise AssertionError(f"rank {r}: launches {g['launches']}, expected {per_rank_want}")
        for part in g["launches"].values():
            add_launches(total, part)
    n = ref["raws"][0].shape[0] // 2
    raw_same = [all(torch.equal(g["raws"][i], ref["raws"][i][r * n:(r + 1) * n])
                    for i in range(2)) for r, g in enumerate(got)]
    raw_err = max(float((g["raws"][i] - ref["raws"][i][r * n:(r + 1) * n]).abs().max())
                  for r, g in enumerate(got) for i in range(2))
    grad_err = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                   for a, b in zip(got[0]["grads"], ref["grads"]))
    param_err = max(float((a - b).abs().max()) for a, b in zip(got[0]["params"], ref["params"]))
    ranks_same = (same_tensors(got[0]["params"], got[1]["params"])
                  and same_tensors(got[0]["grads"], got[1]["grads"])
                  and got[0]["metrics"] == got[1]["metrics"])
    render_same = [all(np.array_equal(a, b) for a, b in zip(g["render"], ref["render"]))
                   for g in got]
    edit_same = [all(np.array_equal(a, b) for a, b in zip(g["edit"], ref["edit"]))
                 for g in got]
    err = np.abs(got[0]["edit"][0] - ref["edit"][0])
    moved = (err.max(-1) > EDIT_RGB_STEP) | (got[0]["edit"][1] != ref["edit"][1])
    edit_mean, edit_frac = float(err.mean()), float(moved.mean())
    print(f"(b) the first step's raws equal to one rank's rows bit for bit {raw_same} (max "
          f"|diff| {raw_err:.3e}); its gradients max relative L2 {grad_err:.3e} (bar "
          f"{GRAD_TOL:.0e}); the ranks' parameters, gradients and metrics bit-identical "
          f"{ranks_same}; parameters after {RANK_STEPS} steps max |two ranks - one rank| "
          f"{param_err:.3e}; metrics {got[0]['metrics']} against one rank's {ref['metrics']}")
    print(f"(b) render equal to one rank's bit for bit {render_same}; edit bit for bit "
          f"{edit_same}, mean abs rgb err {edit_mean:.3e} (bar {EDIT_MEAN_TOL:.0e}), moved or "
          f"relabelled {edit_frac:.4f} of pixels (bar {EDIT_FRAC_TOL:.0%})")
    if not (all(raw_same) and grad_err <= GRAD_TOL and ranks_same and all(render_same)
            and edit_mean <= EDIT_MEAN_TOL and edit_frac <= EDIT_FRAC_TOL
            and all(np.isfinite(v) for v in got[0]["metrics"].values())):
        raise AssertionError("two gloo ranks disagree with one rank")
    print(f"phase 17: launches of the sharded runs {total}; "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return total

def grid_step(mesh, dev, workload):
    """Phase 18(a, c): one step of bench.py's train workload (bf16, seed 0,
    step seed 1) on each pallas_train path under `mesh` (a Mesh2D, or None
    for one rank): the metrics, the gradients and parameters gathered
    whole, this rank's parameter and Adam bytes, and the launches."""
    from dmnerf_torch.parallel.model_parallel import gather_rows, model_sharded
    from dmnerf_torch.train import step as step_mod

    args, scene, cfg = workload
    arrs = step_mod.scene_arrays(scene, dev)
    out = {}
    for pallas in (True, False):
        args.pallas_train = pallas
        state = step_mod.create_train_state(0, cfg, args.lrate, args.lrate_decay, device=dev,
                                            mesh=mesh)
        scan = step_mod.make_train_scan_step(args, cfg, mesh=mesh)
        reset_all_launches()
        m = scan(state, arrs, 1, np.arange(4), 1)
        torch.cuda.synchronize()
        launches = launches_now()
        fields = [state.params[k] for k in ("coarse", "fine")]
        splits = ([s for f in fields for s in f.splits()] if model_sharded(state.params)
                  else [False] * sum(1 for f in fields for _ in f.parameters()))
        params = [p for f in fields for p in f.parameters()]
        whole = (lambda t, s: gather_rows(t, s, mesh)) if mesh is not None else (lambda t, s: t)
        moments = [state.opt.state[p] for p in params]
        out[pallas] = {
            "launches": launches, "metrics": {k: float(v) for k, v in m.items()},
            "grads": [whole(p.grad, s).cpu() for p, s in zip(params, splits)],
            "params": [whole(p.detach(), s).cpu() for p, s in zip(params, splits)],
            "param_bytes": sum(p.numel() * p.element_size() for p in params),
            "adam_bytes": sum(st[k].numel() * st[k].element_size() for st in moments
                              for k in ("exp_avg", "exp_avg_sq")),
            "split_bytes": sum(p.numel() * p.element_size() for p, s in zip(params, splits)
                               if s)}
        del state, scan
        torch.cuda.empty_cache()
    return out


def grid_rank(what, out):
    """A rank of phase 18 under torchrun: `grid1` is make_mesh_2d(1, 1) over
    NCCL and runs grid_step; `grid4` is one of four gloo ranks on cuda:0 and
    runs dryrun_multichip(4), then grid_step on its (2, 2) mesh. Both take
    bench.py's train workload from OUT/bench.pt, waiting until it is there."""
    from dmnerf_torch.graft_entry import dryrun_multichip
    from dmnerf_torch.models.fields import FieldConfig
    from dmnerf_torch.parallel.mesh import close_mesh, make_mesh_2d

    res = {}
    if what == "grid1":
        mesh = make_mesh_2d(1, 1, "cuda", "nccl")
    else:
        t0 = time.perf_counter()
        mesh, res["dryrun_loss"] = dryrun_multichip(4, "cuda:0", "gloo")
        torch.cuda.synchronize()
        res["dryrun_launches"], res["dryrun_s"] = launches_now(), time.perf_counter() - t0
    bench = os.path.join(out, "bench.pt")
    while not os.path.exists(bench):      # the smoke's process writes it meanwhile
        time.sleep(0.2)
    args, scene = torch.load(bench, weights_only=False)
    workload = (args, scene, FieldConfig.from_args(args))
    t0 = time.perf_counter()
    res["steps"] = grid_step(mesh, mesh.device, workload)
    res["steps_s"] = time.perf_counter() - t0
    res["backend"] = torch.distributed.get_backend()
    close_mesh(mesh)
    return res


def model_mesh(dev, card):
    """Phase 18: the 2-D (data, model) mesh on the one card. The NCCL rank,
    the four gloo ranks and this process's one-rank steps overlap; their
    checks follow. Returns the launches of the sharded runs, summed over the
    ranks."""
    from dmnerf_torch.graft_entry import entry
    from dmnerf_torch.tools.trace_step import bench_workload

    phase("18 the 2-D (data, model) mesh: (a) make_mesh_2d(1, 1) over NCCL under torchrun, "
          "one bf16 step of bench.py's train workload on each pallas_train path, against this "
          "process; (b) dryrun_multichip(4) on four gloo ranks sharing cuda:0 as (2, 2); (c) "
          "the same ranks' bf16 step on each path against one rank; graft_entry.entry()")
    t_phase = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc_per_node"]

        def start(n, what):
            return Children([(torchrun + [n, os.path.join(REPO, "chip_smoke.py"), "--rank",
                                          what, tmp], child_env())], f"torchrun {what}", tmp)

        # the gloo ranks' dry run overlaps this process's one-rank steps; the
        # NCCL rank starts after them (the plain steps' activations take
        # ~15 GB a rank at full batch)
        grid4 = start("4", "grid4")
        t0 = time.perf_counter()
        args, scene, cfg = bench_workload()
        torch.save((args, scene), os.path.join(tmp, "bench.tmp"))
        os.replace(os.path.join(tmp, "bench.tmp"), os.path.join(tmp, "bench.pt"))
        ref = grid_step(None, dev, (args, scene, cfg))
        print(f"one rank in this process (the workload's scene included): "
              f"{time.perf_counter() - t0:.1f} s; launches "
              f"{ {p: r['launches'] for p, r in ref.items()} }")
        grid1 = start("1", "grid1")
        reset_all_launches()
        forward, (params, ro, rd) = entry(dev)
        rgb, ins, depth = forward(params, ro, rd)
        torch.cuda.synchronize()
        got = launches_now()
        print(f"graft_entry.entry(): rgb {tuple(rgb.shape)}, ins {tuple(ins.shape)}, depth "
              f"{tuple(depth.shape)}; launches {got}")
        if got != {"field_forward": 2} or not all(bool(torch.isfinite(t).all())
                                                  for t in (rgb, ins, depth)):
            raise AssertionError("entry(): not 2 launches of K1 or a non-finite output")
        del params, forward
        torch.cuda.empty_cache()
        (log1,) = grid1.wait()
        print(f"(a) torchrun grid1: {time.perf_counter() - grid1.t0:.1f} s")
        logs4 = grid4.wait()
        print(f"(b, c) torchrun grid4: {time.perf_counter() - grid4.t0:.1f} s")
        print("\n".join(l for l in logs4[0].splitlines() if l.startswith("dryrun_multichip")))
        one = torch.load(os.path.join(tmp, "grid1.rank0.pt"), weights_only=False)
        four = [torch.load(os.path.join(tmp, f"grid4.rank{r}.pt"), weights_only=False)
                for r in range(4)]

    same = {p: one["backend"] == "nccl" and same_tensors(
        (one["steps"][p]["grads"], one["steps"][p]["params"], one["steps"][p]["metrics"]),
        (r["grads"], r["params"], r["metrics"])) for p, r in ref.items()}
    print(f"(a) make_mesh_2d(1, 1) over {one['backend']} against one process: gradients, "
          f"parameters and metrics bit for bit {same} (pallas_train True, False); "
          f"{one['steps_s']:.1f} s")
    add_launches(total, one["steps"][True]["launches"])
    if not all(same.values()) or one["steps"][True]["launches"] != ref[True]["launches"]:
        raise AssertionError("make_mesh_2d(1, 1) over NCCL differs from one process")

    dry_want = {"field_forward_f32": 40, "field_backward_f32": 16,
                "render_field_sigma_f32": 4, "render_field_all_f32": 4,
                "render_field_ins_f32": 12}
    step_want = {True: {"field_forward": 2, "field_backward": 2}, False: {}}
    full_bytes = ref[True]["param_bytes"]
    for r, g in enumerate(four):
        print(f"(b) rank {r}: dryrun_multichip(4) {g['dryrun_s']:.1f} s, loss "
              f"{g['dryrun_loss']:.4f}, launches {g['dryrun_launches']}; (c) steps "
              f"{g['steps_s']:.1f} s, launches "
              f"{ {p: s['launches'] for p, s in g['steps'].items()} }")
        st = g["steps"][True]
        print(f"(c) rank {r}: parameters {st['param_bytes']:,} B (one rank {full_bytes:,} B, "
              f"{st['param_bytes'] / full_bytes:.4f}), Adam moments {st['adam_bytes']:,} B "
              f"(one rank {ref[True]['adam_bytes']:,} B), split leaves {st['split_bytes']:,} B "
              f"(one rank's split leaves {2 * st['split_bytes']:,} B)")
        if (g["dryrun_launches"] != dry_want
                or {p: s["launches"] for p, s in g["steps"].items()} != step_want):
            raise AssertionError(f"rank {r}: launches {g['dryrun_launches']}, "
                                 f"{ {p: s['launches'] for p, s in g['steps'].items()} }; "
                                 f"expected {dry_want}, {step_want}")
        if (st["param_bytes"] != full_bytes - st["split_bytes"]
                or st["adam_bytes"] != 2 * st["param_bytes"]):
            raise AssertionError(f"rank {r}: its shards are not half of the split leaves")
        add_launches(total, g["dryrun_launches"])
        for s in g["steps"].values():
            add_launches(total, s["launches"])
    for pallas, r in ref.items():
        errs = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in zip(four[0]["steps"][pallas]["grads"], r["grads"])]
        ranks_same = all(same_tensors(g["steps"][pallas]["grads"], four[0]["steps"][pallas]["grads"])
                         for g in four[1:])
        loss_err = abs(four[0]["steps"][pallas]["metrics"]["total_loss"]
                       / r["metrics"]["total_loss"] - 1)
        print(f"(c) pallas_train {pallas}: first-step gradients at (2, 2) against one rank, "
              f"max relative L2 {max(errs):.3e} (median {np.median(errs):.3e}; bar "
              f"{GRAD_TOL:.0e}); the four ranks' gathered gradients bit-identical "
              f"{ranks_same}; total loss {loss_err:.3e} relative")
        if not (max(errs) <= GRAD_TOL and ranks_same and loss_err <= 1e-3):
            raise AssertionError(f"(2, 2) pallas_train {pallas} disagrees with one rank")
    print(f"phase 18: launches of the sharded runs {total}; "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return total


def ab_main(dirs):
    """`python3 chip_smoke.py --ab DIR [DIR ...]`: this tree's kernels
    against those built from each DIR (another tree's
    dmnerf_torch/kernels/csrc, such as a parent commit's unpacked by git
    archive), in one process on one card: K1 and K2 at 3072 rays x 64 and x
    192 points, K4 at 4096 x 64, K3 and K5 at 4096 x 192, on the flagship
    field at K=32, in bf16 and in f32, timed in turns other, this, this,
    other (CUDA events, median of 10; 5 for K2). The bf16 outputs must equal
    this tree's bit for bit; the f32 ones are printed with their largest
    difference, then each f32 build's accuracy (f32_accuracy, and K3/K5's
    f32_composite_accuracy). A DIR needs the f32 composites' layout of
    composite_f32.cuh (pack_field's slabs). All libraries build at once.
    AB_ONLY=prefix[,...]
    in the environment times only the kernels whose "{build} {kernel}"
    label starts with one of them (e.g. "f32 K3,f32 K5")."""
    from dmnerf_torch.kernels import build
    from dmnerf_torch.kernels import field as kf
    from dmnerf_torch.kernels import render_field as krf
    from dmnerf_torch.models.fields import FieldConfig, init_field_params

    if not torch.cuda.is_available():
        print("chip_smoke --ab: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    procs = []
    for i, d in enumerate(dirs):
        out = os.path.join(REPO, "build", "ab", str(i))
        os.makedirs(out, exist_ok=True)
        for lib in ("field", "render_field"):
            so = os.path.join(out, f"lib{lib}.so")
            procs.append((d, lib, so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", so, os.path.join(d, f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            CHILDREN.append(procs[-1][3])
    t0 = time.perf_counter()
    for name, (so, _) in build.build_all(["render_field", "field"]).items():
        print(f"this tree's {name}:\n" + "\n".join(
            l for l in so.with_suffix(".log").read_text().splitlines()
            if "registers" in l or "spill" in l))
    libs = {"this": (build.load_field(), build.load_render_field())}
    other = {}
    for d, lib, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"nvcc failed on {d}/{lib}.cu:\n{log}")
        entries, error = ((build.FIELD_ENTRIES, "field_error_string") if lib == "field" else
                          (build.RENDER_FIELD_ENTRIES, "render_field_error_string"))
        other.setdefault(d, {})[lib] = build.bind(so, entries, error)
    for d in dirs:
        libs[d] = (other[d]["field"], other[d]["render_field"])
    print(f"built {len(procs) + 2} libraries in {time.perf_counter() - t0:.1f} s")
    real = build.load_field, build.load_render_field

    def run(which, fn, reps):
        build.load_field, build.load_render_field = (lambda: libs[which][0]), (lambda: libs[which][1])
        try:
            out = fn(which)
            return (out if isinstance(out, tuple) else (out,)), cuda_ms(lambda: fn(which), reps)
        finally:
            build.load_field, build.load_render_field = real

    g = torch.Generator().manual_seed(0)
    rd = torch.nn.functional.normalize(torch.randn(4096, 3, generator=g), dim=-1).cuda()
    z = (torch.sort(torch.rand(4096, 192, generator=g), -1)[0] * 11 + 1).cuda()
    pts = (torch.randn(4096, 1, 3, generator=g).cuda() * 0.3 + rd[:, None] * z[..., None])
    vd, zc, pc = rd[:, None].contiguous(), z[:, ::3].contiguous(), pts[:, ::3].contiguous()
    for dtype in (torch.bfloat16, torch.float32):
        prec = "bf16" if dtype == torch.bfloat16 else "f32"
        cfg = FieldConfig(**FLAGSHIP, ins_num=32, compute_dtype=dtype)
        pk = krf.pack_field(init_field_params(torch.Generator().manual_seed(1), cfg, device="cuda"))
        fns = {}
        cases = list(field_cases("cuda", 32, 2, 3072, (64, 192), dtype))
        for _, _, fp, fvd, pf, dirs_, ppd, gk in cases:
            S = fp.shape[1]
            fns[f"K1 3072x{S}"] = (10, lambda w, fp=fp, fvd=fvd: kf.field_forward(pk, fp, fvd))
            fns[f"K2 3072x{S}"] = (5, lambda w, pf=pf, d=dirs_, p=ppd, gk=gk: tuple(
                kf.field_backward(pk, pf, d, p, gk)[:2]))
        fns["K4 4096x64"] = (10, lambda w: krf.render_field_sigma(pk, pc, zc, rd))
        fns["K3 4096x192"] = (10, lambda w: krf.render_field_all(pk, pts, vd, z, rd))
        fns["K5 4096x192"] = (10, lambda w: krf.render_field_ins(pk, pts, z, rd))
        only = tuple(os.environ.get("AB_ONLY", "").split(","))
        with torch.no_grad():
            for name, (reps, fn) in fns.items():
                if not f"{prec} {name}".startswith(only):
                    continue
                for d in dirs:
                    (o, o1), (t, t1), (_, t2), (_, o2) = (run(w, fn, reps)
                                                          for w in (d, "this", "this", d))
                    diff = max(float((a - b).abs().max()) for a, b in zip(t, o))
                    print(f"{prec} {name} vs {d}: other {o1:.3f} / {o2:.3f} ms, this {t1:.3f} / "
                          f"{t2:.3f} ms (this/other {min(t1, t2) / min(o1, o2):.3f}), max |this - "
                          f"other| {diff:.3e} ({card})")
                    if prec == "bf16" and not all(torch.equal(a, b) for a, b in zip(t, o)):
                        raise AssertionError(f"bf16 {name}: this tree's output differs from {d}'s")
    for case in cases:
        f32_accuracy(case, {w: libs[w][0] for w in ["this", *dirs]}, card)
    f32_composite_accuracy({w: libs[w][1] for w in ["this", *dirs]}, card)
    return 0


# f32_accuracy: a ReLU input within this of zero may take the other side of
# the step when the products round differently
RELU_NEAR = 1e-5


def f32_accuracy(case, libs, card):
    """For each K1/K2 library of libs ({name: library}) on an f32 case of
    field_cases: K1's raw against an f64 forward (rms of the error over rms
    of the raw, beside the plain f32 path's), and K2's worst gradient
    relative L2 against the plain f32 path, with every point's cotangent and
    with none at the points where a ReLU input of the plain K2 lies within
    RELU_NEAR of zero (its mask may flip)."""
    from dmnerf_torch.kernels import build
    from dmnerf_torch.kernels import field as kf
    field, packed, pts, vd, pf, dirs, ppd, g = case
    rec, relu = [], torch.relu
    torch.relu = lambda x: (rec.append(x.detach().abs().amin(-1)), relu(x))[1]
    try:
        with torch.no_grad():
            gp = kf.field_backward_ref(packed, pf, dirs, ppd, g)
    finally:
        torch.relu = relu
    n = len(rec) // -(-pf.shape[0] // kf.REF_CHUNK)          # ReLUs per chunk of points
    near = torch.stack([torch.cat(rec[i::n]) for i in range(n)]).amin(0) < RELU_NEAR
    g_off = g * ~near[:, None]
    gp_off = kf.field_backward_ref(packed, pf, dirs, ppd, g_off)
    with torch.no_grad():
        raw64 = field.double()(pts.double(), vd.double())
        field.float()
        rms = lambda raw: float((raw.double() - raw64).norm() / raw64.norm())
        plain = rms(kf.field_forward_ref(field, pts, vd))
    real = build.load_field
    try:
        for name, lib in libs.items():
            build.load_field = lambda lib=lib: lib
            with torch.no_grad():
                e_raw = rms(kf.field_forward(packed, pts, vd))
            worst = [max(grad_errors(field, packed, kf.field_backward(packed, pf, dirs, ppd, c),
                                     want)[0].values()) for c, want in ((g, gp), (g_off, gp_off))]
            print(f"f32 accuracy P={pf.shape[0]}, {name}: K1 raw {e_raw:.3e} rms of an f64 forward "
                  f"(plain {plain:.3e}); K2 worst gradient relative L2 {worst[0]:.3e} of the plain "
                  f"path, {worst[1]:.3e} with no cotangent at the {int(near.sum())} points "
                  f"({100 * float(near.float().mean()):.2f}%) with a ReLU input within "
                  f"{RELU_NEAR:.0e} of zero ({card})")
    finally:
        build.load_field = real


def f32_composite_accuracy(libs, card):
    """For each render_field library of libs ({name: library}): K3 and K5
    f32 at 4096 x 192 (the flagship field, K=32) against an f64 run of their
    plain versions (rms of the error over rms of the f64 output, per
    output), beside the plain f32 path's."""
    from dmnerf_torch.kernels import build
    from dmnerf_torch.kernels import render_field as krf
    from dmnerf_torch.models.fields import FieldConfig, init_field_params

    cfg = FieldConfig(**FLAGSHIP, ins_num=32, compute_dtype=torch.float32)
    field = init_field_params(torch.Generator().manual_seed(15), cfg, device="cuda").eval()
    pk = krf.pack_field(field)
    g = torch.Generator().manual_seed(15)
    rd = torch.nn.functional.normalize(torch.randn(4096, 3, generator=g), dim=-1).cuda()
    z = (torch.sort(torch.rand(4096, 192, generator=g), -1)[0] * 11 + 1).cuda()
    pts = (torch.randn(4096, 1, 3, generator=g).cuda() * 0.3 + rd[:, None] * z[..., None])
    vd = rd[:, None].contiguous()
    names = ("K3 rgb", "K3 depth", "K3 ins_logits", "K5 ins_logits")

    def run(f, p, v, zz, r):
        return (*krf.render_field_all_ref(f, p, v, zz, r), krf.render_field_ins_ref(f, p, zz, r))

    with torch.no_grad():
        want = run(field.double(), pts.double(), vd.double(), z.double(), rd.double())
        field.float()
        rms = lambda got: [float((a.double() - b).norm() / b.norm()) for a, b in zip(got, want)]
        rows = {"plain f32": rms(run(field, pts, vd, z, rd))}
        real = build.load_render_field
        try:
            for name, lib in libs.items():
                build.load_render_field = lambda lib=lib: lib
                rows[name] = rms((*krf.render_field_all(pk, pts, vd, z, rd),
                                  krf.render_field_ins(pk, pts, z, rd)))
        finally:
            build.load_render_field = real
    for name, errs in rows.items():
        print(f"f32 composite accuracy, {name}: "
              + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
              + f" rms of an f64 run (4096 x 192; {card})")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    try:
        sys.exit(ab_main(sys.argv[2:]) if sys.argv[1:2] == ["--ab"] else main())
    finally:
        for child in CHILDREN:          # the nvcc builds or ranks of a run that failed
            if child.poll() is None:
                child.kill()
                child.wait()
