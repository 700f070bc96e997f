"""Edited test views as `cli.test --mani_eval` serves them: the port's
edit/runner.py::eval_views (make_pose_image_manipulator, K1 on the raws and
K5 for the accumulated labels, pipelined as manipulator_eval pipelines it)
over poses drawn from the seed, one client in a closed loop (view i+1 is
launched before view i's copy is waited for). In every view the
configuration's object (slot `target_label`) is moved by its transform
(`mani_mode` about `mani_center`): the target pose is transform @ pose. Each
view comes back as rgb, the argmax label over all K+1 channels, and the
label and confidence without the air channel, on the host.

Set-up makes the seed's weights (harness.make_weights with surfaces) and
makes slot `target_label` an object of the scene (object_weights), loads
them into the port's two fields and edits one warm-up view from a pose
outside the test poses. After the window the reference
(benchmark/reference/edit.py) edits a sample of the finished views, drawn
from the seed, from the same weights, poses and transform, and the harness
compares them.
"""

from __future__ import annotations

import itertools
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

from benchmark import harness, scene as scenes
from benchmark.reference.edit import edit_view
from benchmark.reference.field import strict_fp32
from benchmark.reference.render import linear_depths, run_field, view_rays, weights_of

# the reference's rounding of each product's operands at a configuration's
# precision (reference/field.py): the edit's labels are argmaxes, and against
# a float32 reference bf16's rounding flips a share of the exchange decisions
STATED = {"bf16": "bf16", "f32": None}


def transform(cfg: dict) -> np.ndarray:
    """The object's motion [4, 4] (the authors' tools/pose_generator.py):
    the mode's matrix about the object's centre, C^-1 M C. multi: scale 1.2,
    then a quarter turn about z, then -0.25 along y."""
    scale = np.diag([1.2, 1.2, 1.2, 1.0])
    turn = np.eye(4)
    turn[:2, :2] = [[0.0, -1.0], [1.0, 0.0]]
    shift = np.eye(4)
    shift[1, 3] = -0.25
    m = {"translation": shift, "rotation": turn, "scale": scale,
         "multi": scale @ turn @ shift}[cfg["mani_mode"]]
    c, c_inv = np.eye(4), np.eye(4)
    c[:3, 3] = -np.asarray(cfg["mani_center"], np.float64)
    c_inv[:3, 3] = np.asarray(cfg["mani_center"], np.float64)
    return c_inv @ m @ c


def object_weights(cfg: dict, weights: dict, seed: int, device) -> dict:
    """Slot target_label made an object of the scene: in each field the
    instance head's bias of the slot is raised so that the slot is the label
    (the argmax of the composited logits without air) of `object_share` of
    the rays of 8 views drawn from the seed, at 64 linear depths. A random
    field's instance head gives one slot no region on most seeds, and an edit
    of it would then move nothing."""
    label, share = int(cfg["target_label"]), float(cfg["object_share"])
    K = torch.as_tensor(scenes.intrinsics(cfg), device=device)
    c2ws = scenes.poses(cfg, np.random.default_rng([int(seed), 4]), 8)
    rays = [view_rays(int(cfg["H"]), int(cfg["W"]), K, torch.as_tensor(c, device=device))
            for c in c2ws]
    stride = max(1, int(cfg["H"]) * int(cfg["W"]) // 4096)
    ro = torch.cat([o[::stride] for o, _ in rays])
    rd = torch.cat([d[::stride] for _, d in rays])
    z = linear_depths(4096, float(cfg["near"]), float(cfg["far"]), 64, device)
    out = {}
    for name, w in weights.items():
        gaps = []
        with torch.no_grad():
            for s in range(0, ro.shape[0], 4096):
                o, d = ro[s:s + 4096], rd[s:s + 4096]
                zz = z[:o.shape[0]]
                raw = run_field(w, cfg, o, d, zz)
                logits = torch.sum(weights_of(raw[..., 3], zz, d)[..., None] * raw[..., 4:-1], -2)
                others = torch.cat([logits[:, :label], logits[:, label + 1:]], 1).amax(1)
                gaps.append(others - logits[:, label])
            lift = torch.quantile(torch.cat(gaps), share)
        bias = w["ins_linear.bias"].clone()
        bias[label] += torch.clamp(lift, min=0.0)
        out[name] = {**w, "ins_linear.bias": bias}
    return out


def setup(cell, seed: int, device, marks: dict, use_pallas: bool = True) -> dict:
    """The program set up from the seed: its weights, fields, arguments,
    the intrinsics, the poses and the transform."""
    from dmnerf_torch.edit import runner
    from dmnerf_torch.models.fields import DMNeRFField

    if not hasattr(runner, "eval_views"):
        sys.exit("error: this program has no dmnerf_torch/edit/runner.py::eval_views, "
                 "the stream of manipulator_eval's edited views that this cell drives")
    cfg = cell.cfg
    args = harness.program_args(cfg, target_label=int(cfg["target_label"]),
                                use_pallas=use_pallas)
    fcfg = harness.field_config(args)
    weights = object_weights(cfg, harness.make_weights(cfg, seed, device, surfaces=True),
                             seed, device)
    marks["weights"] = time.perf_counter()
    params = {}
    for k in ("coarse", "fine"):
        params[k] = DMNeRFField(fcfg)
        params[k].load_state_dict(weights[k])
        params[k] = params[k].to(device)
    hwk = (int(cfg["H"]), int(cfg["W"]), scenes.intrinsics(cfg))
    trans = transform(cfg)
    marks["program set up"] = time.perf_counter()
    return {"weights": weights, "trans": trans, "K": hwk[2],
            "poses": scenes.test_poses(cfg, seed, int(cell.traffic["poses"]) + 1),
            "views": lambda poses, trans=trans: runner.eval_views(
                fcfg, params, args, hwk, trans, poses, device=device)}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, marks: dict):
    prog = setup(cell, seed, device, marks)
    warm, poses = prog["poses"][:1], prog["poses"][1:]
    for _ in prog["views"](warm):
        pass
    setup_s = time.perf_counter() - t_start
    marks["warm-up view"] = time.perf_counter()

    views = []                      # (pose index, outputs on the host)
    order = itertools.cycle(range(len(poses)))

    def window(secs):
        """Views through eval_views until secs have passed; (views, seconds
        from the first launch to the last view's arrival)."""
        idx = []
        gen = prog["views"](poses[i] for i in _record(order, idx))
        t0 = time.perf_counter()
        n = 0
        for out in gen:
            views.append((idx[n], out))
            n += 1
            if time.perf_counter() - t0 >= secs:
                break
        wall = time.perf_counter() - t0
        gen.close()                 # the view launched ahead is not counted
        return n, wall

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    metrics, ctx = {}, {"cfg": cell.cfg}
    if not trace:
        n, wall = window(seconds)
        sync()
        metrics["view_ms"] = {"value": 1e3 * wall / n, "unit": "ms"}
    else:
        n1, wall1 = window(seconds / 2)
        sync()
        ctx["untraced"] = {"views": n1, "seconds": wall1}
        with harness.profiled(device) as prof:
            n2, _ = window(seconds / 2)
        ctx["traced"] = {"views": n2, "trace": prof["trace"]}
        n = n1 + n2
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = sum(1 for _, out in views if not all(np.isfinite(a).all() for a in out))

    weights, trans, K = prog["weights"], prog["trans"], prog["K"]
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng([int(seed), 3])
    sample = rng.choice(len(views), size=min(len(views), int(cell.traffic["checked_views"])),
                        replace=False)
    readings = compare(cell, weights, K, trans, [(poses[views[i][0]], views[i][1])
                                                 for i in sample], device)
    return {"attempted": n, "failed": failed, "metrics": metrics, "setup_s": setup_s,
            "peak": peak, "readings": readings, "ctx": ctx}


def _record(it, seen: list):
    for i in it:
        seen.append(i)
        yield i


def view_readings(prog, ref: dict) -> dict:
    """Numbers of one view: the program's (rgb, label over all K+1 channels,
    label and confidence without air) on the host against the reference's
    edit of the same pose. rgb_p50 and rgb_p90: the median and the 90th
    percentile pixel's largest channel error; label_gap_p999: the 99.9th
    percentile of the reference's confidence in its best slot less its
    confidence in the program's label (without air); label_off: the share
    of pixels whose label over all K+1 channels is not the reference's.
    Quantiles are taken over every 7th pixel."""
    dev = ref["rgb"].device
    rgb, label_full, label, _ = (torch.as_tensor(np.asarray(a)).to(dev) for a in prog)
    rgb = rgb.reshape(-1, 3)
    label, label_full = label.reshape(-1).long(), label_full.reshape(-1).long()
    err = (rgb - ref["rgb"]).abs().amax(-1)
    gap = ref["conf"] - ref["ins"][:, :-1].gather(1, label[:, None])[:, 0]
    q = lambda x, p: float(torch.quantile(x.float()[::7], p))
    return {"rgb_p50": q(err, 0.5), "rgb_p90": q(err, 0.9), "label_gap_p999": q(gap, 0.999),
            "label_off": float((label_full != ref["label_full"]).float().mean())}


def _reference(cell, weights, K, trans, c2w, device, quantize) -> dict:
    Kt = torch.as_tensor(K, device=device)
    tar = torch.as_tensor((trans @ np.asarray(c2w, np.float64)).astype(np.float32),
                          device=device)
    return edit_view(weights["coarse"], weights["fine"], cell.cfg, Kt,
                     torch.as_tensor(c2w, device=device), [tar], [int(cell.cfg["target_label"])],
                     block=int(cell.cfg["N_test"]), quantize=quantize)


def compare(cell, weights, K, trans, checked, device) -> dict:
    """The worst view's numbers over the checked (pose, outputs) pairs."""
    strict_fp32()
    worst = {}
    for c2w, out in checked:
        ref = _reference(cell, weights, K, trans, c2w, device, STATED[cell.cfg["precision"]])
        for k, v in view_readings(out, ref).items():
            worst[k] = max(worst.get(k, -np.inf), v)
    worst["views_checked"] = len(checked)
    return worst


@contextmanager
def _second_exchange_skipped():
    """The planted fault (b): manipulate_chunk's second exchanger call gives
    back the original rays' fine samples unexchanged."""
    from dmnerf_torch.edit import manipulator

    real, calls = manipulator.exchanger, [0]

    def exchanger(ori_raw, *a, **kw):
        calls[0] += 1
        return ori_raw if calls[0] % 2 == 0 else real(ori_raw, *a, **kw)

    manipulator.exchanger = exchanger
    try:
        yield
    finally:
        manipulator.exchanger = real


def readings(cell, seed: int, device, detail: bool = False) -> dict:
    """The readings that the limits are set from, on one seed (readings.py),
    each the worst of the first `checked_views` poses, against the reference
    at the configuration's precision: the program's views ("program"), three
    faults planted in the program: the object not moved, the target pose the
    original pose ("fault_unmoved"); manipulate_chunk's second exchanger
    skipped ("fault_second_exchange"); the labels of the first chunk of rays
    moved one slot on ("fault_answer"); and, on the first pose alone (a
    reference view takes ~35 s on an H100), the reference computed in fp8
    ("control_fp8"). With `detail`, also the port's plain PyTorch path
    (use_pallas False; "program_plain"), and on the first pose the program
    and the control against a float32 reference ("program_vs_f32",
    "control_fp8_vs_f32")."""
    marks = {}
    prog = setup(cell, seed, device, marks)
    n = int(cell.traffic["checked_views"])
    poses = prog["poses"][:n]
    outs = {"program": list(prog["views"](poses)),
            "fault_unmoved": list(prog["views"](poses, trans=np.eye(4)))}
    with _second_exchange_skipped():
        outs["fault_second_exchange"] = list(prog["views"](poses))
    weights, trans, K = prog["weights"], prog["trans"], prog["K"]
    del prog
    if detail:
        plain = setup(cell, seed, device, marks, use_pallas=False)
        outs["program_plain"] = list(plain["views"](poses))
        del plain
    if device.type == "cuda":
        torch.cuda.empty_cache()
    strict_fp32()
    chunk, ins_num = int(cell.cfg["N_test"]), int(cell.cfg["ins_num"])
    res = {}
    for i, c2w in enumerate(poses):
        ref = _reference(cell, weights, K, trans, c2w, device, STATED[cell.cfg["precision"]])
        views = {k: v[i] for k, v in outs.items()}
        answer = [np.array(a) for a in outs["program"][i]]
        answer[1][:chunk] = (answer[1][:chunk] + 1) % (ins_num + 1)
        answer[2][:chunk] = (answer[2][:chunk] + 1) % ins_num
        views["fault_answer"] = answer
        pairs = [(key, o, ref) for key, o in views.items()]
        if i == 0:
            ctl = _reference(cell, weights, K, trans, c2w, device, "fp8")
            ctl = tuple(ctl[k].cpu().numpy() for k in ("rgb", "label_full", "label", "conf"))
            pairs.append(("control_fp8", ctl, ref))
            if detail:
                f32 = _reference(cell, weights, K, trans, c2w, device, None)
                pairs += [("program_vs_f32", views["program"], f32),
                          ("control_fp8_vs_f32", ctl, f32)]
        for key, o, r in pairs:
            for k, v in view_readings(o, r).items():
                res.setdefault(key, {})[k] = max(res.get(key, {}).get(k, -np.inf), v)
    return res
