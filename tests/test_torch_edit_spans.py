"""The edit's spans (utils/profiling.py::span) on the CPU: one `edit.view` a
view of edit/runner.py::eval_views, inside it each chunk's disjoint phases
in the order of manipulate_chunk's chain, and no record_function call while
no profiler runs; then trace_step's span table and the benchmark's readers
of the dmsr-edit cell on a hand-made trace with known idle intervals."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import counts, harness, trace_summary
from dmnerf_torch.config import default_config
from dmnerf_torch.data.synthetic import make_scene
from dmnerf_torch.edit import runner
from dmnerf_torch.models.fields import DMNeRFField, FieldConfig
from dmnerf_torch.tools import trace_step
from dmnerf_torch.utils import profiling

CHUNK = ["edit.coarse", "edit.resample", "edit.accum", "edit.exchange", "edit.resample",
         "edit.fine", "edit.exchange", "edit.fine"]


def _views(poses):
    """eval_views of a toy field on an 8x8 view in two chunks of 32 rays,
    slot 1 moved by a shift in x."""
    scene = make_scene(H=8, W=8, n_train=1, n_test=2)
    args = default_config(N_samples=4, N_importance=4, near=1.0, far=12.0, precision="f32",
                          netdepth=2, netwidth=32, multires=2, multires_views=2, N_test=32,
                          ins_num=scene.ins_num, target_label=1, use_pallas=False)
    cfg = FieldConfig.from_args(args)
    params = {k: DMNeRFField(cfg) for k in ("coarse", "fine")}
    trans = np.eye(4)
    trans[0, 3] = 0.5
    return list(runner.eval_views(cfg, params, args, (8, 8, scene.K), trans,
                                  scene.poses[:poses], device="cpu"))


def test_eval_views_records_one_view_span_with_its_chunk_phases_in_order():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert len(_views(2)) == 2
    ev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.name.startswith("edit.")), key=lambda x: (x[0], -x[1]))
    views = [e for e in ev if e[2] == "edit.view"]
    assert len(views) == 2
    for a, b, _ in views:
        kids = [e for e in ev if a <= e[0] and e[1] <= b and e[2] != "edit.view"]
        assert [e[2] for e in kids] == CHUNK * 2
        assert all(x[1] <= y[0] for x, y in zip(kids, kids[1:]))
    assert len(ev) == 2 * (1 + 2 * len(CHUNK))


def test_edit_spans_make_no_record_function_call_without_a_profiler(monkeypatch):
    calls = []
    real = profiling.record_function

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counted)
    assert len(_views(1)) == 1
    assert calls == []


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


K1 = "void (anonymous namespace)::field_forward_kernel<__nv_bfloat16>(float const*)"
K5 = "void (anonymous namespace)::composite_kernel<((anonymous namespace)::Heads)1>(float const*)"
# One edited view (us): edit.view over 0-1000 with one chunk's eight phases;
# K1 at 30-230 and 520-800, a sort at 240-260, K5 at 320-500, an elementwise
# kernel at 805-820 and the copy out at 830-840. Idle: 0-30, 230-240,
# 260-320, 500-520, 800-805, 820-830, 840-1000 (295 in all).
EDIT_TRACE = {"traceEvents": [
    _ev("edit.view", "user_annotation", 0, 1000),
    _ev("edit.coarse", "user_annotation", 10, 190),
    _ev("cudaLaunchKernel", "cuda_runtime", 20, 5, corr=1),
    _ev(K1, "kernel", 30, 200, tid=7, corr=1),
    _ev("edit.resample", "user_annotation", 200, 100),
    _ev("void at::native::radixSortKVInPlace<2, -1, 32, 32, float, long>", "kernel", 240, 20,
        tid=7),
    _ev("edit.accum", "user_annotation", 300, 100),
    _ev("cudaLaunchKernel", "cuda_runtime", 310, 5, corr=2),
    _ev(K5, "kernel", 320, 180, tid=7, corr=2),
    _ev("edit.exchange", "user_annotation", 400, 50),
    _ev("edit.resample", "user_annotation", 450, 50),
    _ev("edit.fine", "user_annotation", 500, 200),
    _ev(K1, "kernel", 520, 280, tid=7),
    _ev("edit.exchange", "user_annotation", 700, 60),
    _ev("edit.fine", "user_annotation", 760, 40),
    _ev("void at::native::elementwise_kernel<128, 2>", "kernel", 805, 15, tid=7),
    _ev("cudaMemcpyAsync", "cuda_runtime", 825, 5, corr=3),
    _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 830, 10, tid=7, corr=3),
]}
# (calls, host ms, device-idle ms)
EDIT_WANT = {"edit.view": (1, 1.0, 0.295), "edit.coarse": (1, 0.19, 0.02),
             "edit.resample": (2, 0.15, 0.05), "edit.accum": (1, 0.1, 0.02),
             "edit.exchange": (2, 0.11, 0.0), "edit.fine": (2, 0.24, 0.02)}


def test_span_table_reads_the_edit_spans():
    """trace_step's table: the edit's spans in the order they first open,
    the three that open twice a chunk counted twice, and edit.view's self
    time what its phases leave of it."""
    s = trace_step.summarize(EDIT_TRACE)["spans"]
    assert list(s) == list(EDIT_WANT)
    for name, (calls, host, idle) in EDIT_WANT.items():
        assert s[name]["calls"] == calls, name
        assert s[name]["host_ms"] == pytest.approx(host, abs=1e-9), name
        assert s[name]["idle_ms"] == pytest.approx(idle, abs=1e-9), name
    assert s["edit.view"]["self_ms"] == pytest.approx(1.0 - 0.79, abs=1e-9)


def _ctx(trace, views=1):
    return {"cfg": harness.load_cell("dmsr-edit").cfg,
            "traced": {"views": views, "trace": trace,
                       "summary": trace_summary.summarize(trace)}}


@pytest.mark.parametrize("metric,value", [("view_idle_ms.edit", 0.295),
                                          ("exchange_ms.edit", 0.110),
                                          ("device_idle.edit", 29.5)])
def test_edit_span_readers_on_the_hand_made_trace(metric, value):
    """Per edit.view span (the traced window's views, the one launched ahead
    included); nothing to read without the spans (the parent's program), on
    a trace without device events (a run on the CPU) or untraced."""
    read = harness.layer_reader(metric)
    assert read(_ctx(EDIT_TRACE)) == pytest.approx(value)
    two = {"traceEvents": EDIT_TRACE["traceEvents"] + [
        dict(e, ts=e["ts"] + 1000) for e in EDIT_TRACE["traceEvents"]]}
    assert read(_ctx(two, views=1)) == pytest.approx(value)
    cpu = {"traceEvents": [e for e in EDIT_TRACE["traceEvents"]
                           if e["cat"] in ("user_annotation", "cpu_op")]}
    assert read(_ctx(cpu)) is None
    assert read({"cfg": {}, "untraced": {"views": 2, "seconds": 1.0}}) is None
    if metric != "device_idle.edit":
        bare = {"traceEvents": [e for e in EDIT_TRACE["traceEvents"]
                                if e["cat"] != "user_annotation"]}
        assert read(_ctx(bare)) is None


def test_edit_kernel_readers_count_from_the_launches():
    """k1_roofline.edit: each K1 launch is N_test x (N_samples + N_importance)
    points on average (two coarse at x 64, two fine at x 320 a chunk), the
    whole field's MACs a point; k5_roofline.edit: each K5 launch is N_test x
    (N_samples + N_importance) points of the trunk, density and instance
    branch. Both bound by the operations at these shapes."""
    ctx = _ctx(EDIT_TRACE)
    cfg = ctx["cfg"]
    k1 = 2.0 * counts.forward_macs(cfg) * 2 * 4096 * 192 / counts.PEAK_BF16_FLOPS
    assert harness.layer_reader("k1_roofline.edit")(ctx) == pytest.approx(100 * k1 / 480e-6)
    ins = 256 * 256 + 256 * 128 + 128 * 33
    k5 = 2.0 * (counts.trunk_macs(cfg) + ins) * 4096 * 192 / counts.PEAK_BF16_FLOPS
    assert harness.layer_reader("k5_roofline.edit")(ctx) == pytest.approx(100 * k5 / 180e-6)
    bare = {"traceEvents": [e for e in EDIT_TRACE["traceEvents"] if e["cat"] != "kernel"]}
    for m in ("k1_roofline.edit", "k5_roofline.edit"):
        assert harness.layer_reader(m)(_ctx(bare)) is None
        assert harness.layer_reader(m)({"cfg": cfg}) is None


def test_edit_mfu_counts_768_k1_and_384_k5_points_a_ray():
    cfg = harness.load_cell("dmsr-edit").cfg
    ins = 256 * 256 + 256 * 128 + 128 * 33
    per_view = 2.0 * (768 * 695_936 + 384 * (counts.trunk_macs(cfg) + ins)) * 640 * 480
    read = harness.layer_reader("edit_mfu")
    assert read({"cfg": cfg, "untraced": {"views": 4, "seconds": 10.0}}) == pytest.approx(
        100 * per_view * 4 / 10.0 / counts.PEAK_BF16_FLOPS)
    assert read({"cfg": cfg, "traced": {"views": 4}}) is None
