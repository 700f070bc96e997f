"""The training loop as a user runs it per scene: the port's
make_train_scan_step, one step per call, each step's view drawn uniformly
from the training views and its pixels, jitter and importance samples from
the step's seed.

Set-up builds the step with its fields and Adam state, loads the seed's
weights, and takes the first `checked_steps` steps through the window's own
call (they build the kernels); the window then trains the same state on.
After the window the reference, with each product's operands rounded to
the configuration's precision (reference/field.py), follows those first
steps from the same weights and scene, and the harness compares each step's
loss, the first gradient as Adam holds it, and the change of the weights
after the last checked step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, scene as scenes
from benchmark.reference.field import strict_fp32
from benchmark.reference.train import Trainer

BETA1 = 0.9


def setup(cell, seed: int, device, marks: dict):
    from dmnerf_torch.train.step import (SceneArrays, create_train_state,
                                         make_train_scan_step)

    cfg = cell.cfg
    args = harness.program_args(cfg, perturb=1.0 if cell.traffic["perturb"] else 0.0,
                                pallas_train=True)
    fcfg = harness.field_config(args)
    sc = scenes.make(cfg, seed, int(cfg["train_views"]), device)
    weights = harness.make_weights(cfg, seed, device)
    marks["scene and weights"] = time.perf_counter()
    state = create_train_state(0, fcfg, float(cfg["lrate"]), int(cfg["lrate_decay"]),
                               device=device)
    for k in ("coarse", "fine"):
        state.params[k].load_state_dict(weights[k])
    scan = make_train_scan_step(args, fcfg)
    arrs = SceneArrays(sc["images"], sc["labels"], sc["poses"], sc["K"])
    i_train = np.arange(sc["images"].shape[0])
    base_seed = harness.sub_seeds(seed, 3)[2]
    marks["program set up"] = time.perf_counter()
    return sc, weights, state, lambda: scan(state, arrs, base_seed, i_train, 1), base_seed


def leaves(state):
    return {(k, n): p for k in ("coarse", "fine") for n, p in state.params[k].named_parameters()}


def checked_steps(state, step, n: int, marks: dict):
    """The first n steps, through the window's call: their losses, the
    gradient of the first (from Adam's first moment after it) and the
    weights after the last."""
    losses, grads = [], None
    for i in range(n):
        m = step()
        losses.append(torch.stack([m["total_loss"], m["rgb_loss"]]))
        if i == 0:
            marks["first step"] = time.perf_counter()
            grads = {key: (state.opt.state[p]["exp_avg"] / (1 - BETA1)).clone()
                     if "exp_avg" in state.opt.state.get(p, {}) else torch.zeros_like(p)
                     for key, p in leaves(state).items()}
    weights = {key: p.detach().clone() for key, p in leaves(state).items()}
    return torch.stack(losses).cpu().tolist(), grads, weights


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, marks: dict):
    sc, weights, state, step, base_seed = setup(cell, seed, device, marks)
    n_check = int(cell.traffic["checked_steps"])
    losses, grads, after = checked_steps(state, step, n_check, marks)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    marks["checked steps"] = time.perf_counter()

    n_train = int(cell.cfg["N_train"])
    window_losses = []

    def work():
        window_losses.append(step()["total_loss"])

    metrics, ctx = {}, {"cfg": cell.cfg}
    if not trace:
        if device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True)]
            events[0].record()

            def work_timed():
                work()
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            n, wall = harness.timed_window(seconds, work_timed, sync)
            step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        else:                       # the CPU: each step is done when its call returns
            step_ms = []

            def work_timed():
                t0 = time.perf_counter()
                work()
                step_ms.append(1e3 * (time.perf_counter() - t0))
            n, wall = harness.timed_window(seconds, work_timed, sync)
        metrics = {"train_rays_per_s": {"value": n * n_train / wall, "unit": "rays/s"},
                   "train_step_ms_p95": {"value": float(np.percentile(step_ms, 95)),
                                         "unit": "ms"}}
    else:
        n1, wall1 = harness.timed_window(seconds / 2, work, sync)
        ctx["untraced"] = {"steps": n1, "seconds": wall1}
        with harness.profiled(device) as prof:
            n2, _ = harness.timed_window(seconds / 2, work, lambda: None)
        ctx["traced"] = {"steps": n2, "trace": prof["trace"]}
        n = n1 + n2
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())

    # the program's state goes before the reference runs
    del state, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = compare(cell, weights, sc, base_seed, losses, grads, after)
    return {"attempted": n, "failed": failed, "metrics": metrics, "setup_s": setup_s, "peak": peak,
            "readings": readings, "ctx": ctx}


def norms(d: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


def worst_gap(prog: dict, ref: dict, keep) -> float:
    """The largest gap between a leaf's norm in the program and in the
    reference, over the larger of the reference leaf's norm and the median
    leaf's."""
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


# the reference's rounding of each product's operands at a configuration's
# stated precision (reference/field.py): bf16 products summed in float32
STATED = {"bf16": "bf16", "f32": None}


def reference_run(cell, weights, sc, base_seed: int, n: int, control: bool = False,
                  keep_rays: float = 1.0):
    """The reference's first n steps at the configuration's precision, or in
    fp8 as the control: (losses, first gradients, weights after)."""
    strict_fp32()
    quantize = "fp8" if control else STATED[cell.cfg["precision"]]
    tr = Trainer(cell.cfg, weights, sc, base_seed, quantize=quantize, keep_rays=keep_rays)
    losses, grads = [], None
    for s in range(n):
        loss, rgb, g = tr.step(s)
        losses.append([loss, rgb])
        if s == 0:
            grads = {(k, name): t for k, w in g.items() for name, t in w.items()}
    after = {(k, name): t.detach() for k, w in tr.params.items() for name, t in w.items()}
    return losses, grads, after


def readings_of(weights, losses, grads, after, ref) -> dict:
    """The numbers of a run ([total, photometric] loss of each step, first
    gradients and weights after) against the reference's. loss_gap: the
    worst relative gap of a step's loss; change_gap: the worst leaf's gap
    between the norms of the weights' change after the checked steps;
    grad_diff_median: the median leaf's norm of the first gradient's
    difference; grad_gap: the worst leaf's gap of the first gradient's norms.
    Each leaf's is over the larger of the reference leaf's norm and the
    median leaf's. rgb_grad_p50: the median, over the elements of the rgb
    head's leaves (both fields), of the first gradient's error relative to the
    reference's element; only the photometric loss reaches these leaves, one
    term a ray, so a batch with rays left out moves them most. Leaves whose
    reference gradient is under a thousandth of the median leaf's are left out
    (round-off moves them)."""
    r_losses, r_grads, r_after = ref
    g_ref = norms(r_grads)
    med = float(np.median(list(g_ref.values())))
    keep = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    w0 = {(k, n): t for k, w in weights.items() for n, t in w.items()}
    d_prog = norms({k: after[k].float() - w0[k] for k in keep})
    d_ref = norms({k: r_after[k] - w0[k] for k in keep})
    diff = {k: float(torch.linalg.norm((grads[k] - r_grads[k]).double())) / max(g_ref[k], med)
            for k in keep}
    rgb = [k for k in keep if k[1].startswith("rgb")] or keep
    g_r = torch.cat([r_grads[k].double().flatten() for k in rgb])
    g_p = torch.cat([grads[k].double().flatten() for k in rgb])
    nz = g_r != 0
    return {"loss_gap": max(abs(p[0] - r[0]) / abs(r[0]) for p, r in zip(losses, r_losses)),
            "change_gap": worst_gap(d_prog, d_ref, keep),
            "grad_diff_median": float(np.median(list(diff.values()))),
            "rgb_grad_p50": float(torch.median((g_p[nz] - g_r[nz]).abs() / g_r[nz].abs())),
            "grad_gap": worst_gap(norms(grads), g_ref, keep),
            "leaves_left_out": len(g_ref) - len(keep)}


def compare(cell, weights, sc, base_seed, losses, grads, after) -> dict:
    ref = reference_run(cell, weights, sc, base_seed, len(losses))
    return readings_of(weights, losses, grads, after, ref)


def readings(cell, seed: int, device, detail: bool = False) -> dict:
    """The readings that the limits are set from, on one seed (readings.py):
    the program's checked steps against the reference ("program"), the
    reference in fp8 ("control_fp8", the precision below bf16), and the
    reference with half of each batch's rays left out, the mean taken over the
    rest ("fault_half_batch"). A step that leaves the state unchanged reads 1
    on change_gap by its definition. With `detail`, also each leaf's
    reference gradient norm and the norm of each side's difference from it
    ("leaves": [reference, program, control, half batch])."""
    marks = {}
    sc, weights, state, step, base_seed = setup(cell, seed, device, marks)
    n = int(cell.traffic["checked_steps"])
    losses, grads, after = checked_steps(state, step, n, marks)
    del state, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_run(cell, weights, sc, base_seed, n)
    runs = {"program": (losses, grads, after),
            "control_fp8": reference_run(cell, weights, sc, base_seed, n, control=True),
            "fault_half_batch": reference_run(cell, weights, sc, base_seed, n, keep_rays=0.5)}
    out = {k: readings_of(weights, *r, ref) for k, r in runs.items()}
    if detail:
        out["leaves"] = {"/".join(k): [float(torch.linalg.norm(g.double()))]
                         + [float(torch.linalg.norm((r[1][k] - g).double()))
                            for r in runs.values()]
                         for k, g in ref[1].items()}
    return out
