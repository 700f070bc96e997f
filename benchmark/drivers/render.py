"""Test views as `cli.test --render` serves them: the port's
make_image_renderer(...).many over poses drawn from the seed, one client in
a closed loop (view i+1 is launched before view i's copy is waited for, as
the program pipelines it). Each view comes back as rgb, the argmax label,
its confidence and depth on the host.

Set-up loads the seed's weights into the port's two fields and renders one
warm-up view from a pose outside the test poses. After the window the
reference renders a sample of the finished views, drawn from the seed, from
the same weights and poses, and the harness compares them.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from benchmark import harness, scene as scenes
from benchmark.reference.field import strict_fp32
from benchmark.reference.render import render_view


def setup(cell, seed: int, device, marks: dict, use_pallas: bool = True):
    from dmnerf_torch.eval.renderer import make_image_renderer
    from dmnerf_torch.models.fields import DMNeRFField

    cfg = cell.cfg
    args = harness.program_args(cfg)
    fcfg = harness.field_config(args)
    weights = harness.make_weights(cfg, seed, device, surfaces=True)
    marks["weights"] = time.perf_counter()
    params = {}
    for k in ("coarse", "fine"):
        params[k] = DMNeRFField(fcfg)
        params[k].load_state_dict(weights[k])
        params[k] = params[k].to(device)
    render_im = make_image_renderer(fcfg, args, int(cfg["H"]), int(cfg["W"]), device=device,
                                    use_pallas=use_pallas)
    K = scenes.intrinsics(cfg)
    poses = scenes.test_poses(cfg, seed, int(cell.traffic["poses"]) + 1)
    marks["program set up"] = time.perf_counter()
    return weights, params, render_im, K, poses


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, marks: dict):
    weights, params, render_im, K, poses = setup(cell, seed, device, marks)
    warm, poses = poses[:1], poses[1:]
    for _ in render_im.many(params, K, warm):
        pass
    setup_s = time.perf_counter() - t_start
    marks["warm-up view"] = time.perf_counter()

    views = []                      # (pose index, outputs on the host)
    order = itertools.cycle(range(len(poses)))

    def window(secs):
        """Views through .many until secs have passed; (views, seconds from
        the first launch to the last view's arrival)."""
        idx = []
        it = (poses[i] for i in _record(order, idx))
        gen = render_im.many(params, K, it)
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

    del params, render_im
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng([int(seed), 3])
    sample = rng.choice(len(views), size=min(len(views), int(cell.traffic["checked_views"])),
                        replace=False)
    readings = compare(cell, weights, K, [(poses[views[i][0]], views[i][1]) for i in sample],
                       device)
    return {"attempted": n, "failed": failed, "metrics": metrics, "setup_s": setup_s,
            "peak": peak, "readings": readings, "ctx": ctx}


def _record(it, seen: list):
    for i in it:
        seen.append(i)
        yield i


def view_readings(cfg: dict, prog, ref: dict) -> dict:
    """Numbers of one view: the program's (rgb, label, conf, depth) on the
    host against the reference's render of the same pose. rgb_p50: the
    median pixel's largest channel error; depth_p50: the median depth error
    over far - near of the pixels whose reference opacity is 0.5 or more;
    label_gap_p999: the 99.9th percentile of the reference's confidence in
    its best slot less its confidence in the program's label. Quantiles are
    taken over every 7th pixel."""
    dev = ref["rgb"].device
    rgb, label, conf, depth = (torch.as_tensor(np.asarray(a)).to(dev) for a in prog)
    rgb, label, depth = rgb.reshape(-1, 3), label.reshape(-1).long(), depth.reshape(-1)
    span = float(cfg["far"]) - float(cfg["near"])
    gap = ref["conf"] - ref["ins"].gather(1, label[:, None])[:, 0]
    err = (rgb - ref["rgb"]).abs().amax(-1)
    derr = (depth - ref["depth"]).abs() / span
    q = lambda x, p: float(torch.quantile(x.float()[::7], p))
    opaque = ref["acc"] >= 0.5
    dop = derr[opaque] if bool(opaque.any()) else derr
    return {"rgb_p50": q(err, 0.5), "depth_p50": q(dop, 0.5), "label_gap_p999": q(gap, 0.999)}


def compare(cell, weights, K, checked, device) -> dict:
    """The worst view's numbers over the checked (pose, outputs) pairs."""
    strict_fp32()
    Kt = torch.as_tensor(K, device=device)
    worst = {}
    for c2w, out in checked:
        ref = render_view(weights["coarse"], weights["fine"], cell.cfg, Kt,
                          torch.as_tensor(c2w, device=device))
        for k, v in view_readings(cell.cfg, out, ref).items():
            worst[k] = max(worst.get(k, -np.inf), v)
    worst["views_checked"] = len(checked)
    return worst


def readings(cell, seed: int, device, detail: bool = False) -> dict:
    """The readings that the limits are set from, on one seed (readings.py),
    each the worst of the first `checked_views` poses: the program's views
    against the reference ("program"), the reference rendered in fp8
    ("control_fp8"), and two faults planted in the program's views: the
    labels of the first chunk of rays moved one slot on ("fault_answer"),
    and the first chunk answered by the outputs of the chunk in the middle of
    the view ("fault_far_chunk"). With `detail`, also the port's plain
    PyTorch path (use_pallas False) against the reference
    ("program_plain"), which tells the kernels' share of a reading from
    bf16's, and the program's and the control's numbers view by view."""
    marks = {}
    weights, params, render_im, K, poses = setup(cell, seed, device, marks)
    n = int(cell.traffic["checked_views"])
    outs = {"program": list(render_im.many(params, K, poses[:n]))}
    del params, render_im
    if detail:
        _, params, render_im, _, _ = setup(cell, seed, device, marks, use_pallas=False)
        outs["program_plain"] = list(render_im.many(params, K, poses[:n]))
        del params, render_im
    if device.type == "cuda":
        torch.cuda.empty_cache()
    strict_fp32()
    Kt = torch.as_tensor(K, device=device)
    chunk, ins_num = int(cell.cfg["N_test"]), int(cell.cfg["ins_num"])
    res = {}
    for i, c2w in enumerate(poses[:n]):
        c2w = torch.as_tensor(c2w, device=device)
        ref = render_view(weights["coarse"], weights["fine"], cell.cfg, Kt, c2w)
        ctl = render_view(weights["coarse"], weights["fine"], cell.cfg, Kt, c2w, quantize="fp8")
        views = {k: v[i] for k, v in outs.items()}
        views["control_fp8"] = tuple(ctl[k].cpu().numpy() for k in ("rgb", "label", "conf",
                                                                    "depth"))
        flat = [np.array(a).reshape(-1, *a.shape[2:]) for a in outs["program"][i]]
        answer = [a.copy() for a in flat]
        answer[1][:chunk] = (answer[1][:chunk] + 1) % ins_num
        far = [a.copy() for a in flat]
        mid = (len(far[0]) // chunk // 2) * chunk
        for a in far:
            a[:chunk] = a[mid:mid + chunk]
        views["fault_answer"], views["fault_far_chunk"] = answer, far
        for key, o in views.items():
            r = view_readings(cell.cfg, o, ref)
            if detail and key in ("program", "control_fp8"):
                res.setdefault(key + "_views", []).append(r)
            for k, v in r.items():
                res.setdefault(key, {})[k] = max(res.get(key, {}).get(k, -np.inf), v)
    return res
