"""The port's profiling and run-record tools on the CPU: `cli.train
--profile_steps` writes a torch.profiler trace and the same metrics as an
untraced run; trace_step's reader on a committed Chrome-trace fixture with
known durations (tests/torch_golden/trace/fixture.pt.trace.json); the
program's spans (utils/profiling.py::span) in the train step and the render
view, and their readers, trace_step's span table and the benchmark's
(benchmark/spans.py), on a hand-made trace with known idle intervals;
check_resume_replay on a resumed run's metrics.jsonl; and quality_curve on a
run's in-training evals."""

import gzip
import json
import os
import shutil

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, spans as bench_spans
from dmnerf_torch.cli import train as cli_train
from dmnerf_torch.config import default_config
from dmnerf_torch.data.synthetic import make_scene
from dmnerf_torch.eval.renderer import make_image_renderer
from dmnerf_torch.models.fields import DMNeRFField, FieldConfig
from dmnerf_torch.tools import check_resume_replay, quality_curve, trace_step
from dmnerf_torch.train.step import create_train_state, make_train_scan_step, scene_arrays
from dmnerf_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_golden", "trace")


def _config(tmp_path, name, **over):
    flags = dict(expname=name, basedir=str(tmp_path / "logs"), log_time="run",
                 datadir="./data/synthetic/boxroom8x4", N_train=32, N_test=64, N_samples=4,
                 N_importance=4, near=1.0, far=12.0, netdepth=2, netwidth=32, multires=2,
                 multires_views=2, tolerance=0.05, deta_w=0.05, n_iters=5, i_print=2,
                 i_save=8, i_test=0, eval_views=1)
    flags.update(over)
    path = tmp_path / f"{name}.txt"
    path.write_text("\n".join(f"{k} = {v}" for k, v in flags.items()) + "\npenalize\n")
    return str(path)


def _metrics(tmp_path, name):
    path = tmp_path / "logs" / name / "run" / "metrics.jsonl"
    return [json.loads(line) for line in open(path)]


def test_profile_steps_writes_a_trace_and_the_same_metrics(tmp_path, capsys):
    """--profile_steps 1 --scan_steps 2 on the CPU: dispatch 0 is left out,
    dispatch 1 (steps 3-4) is traced into {logdir}/profile, and metrics.jsonl
    equals the untraced run's but for rays_per_sec."""
    for name, extra in (("plain", []), ("traced", ["--profile_steps", "1"])):
        cli_train.main(["--config", _config(tmp_path, name), "--scan_steps", "2",
                        "--device", "cpu", *extra])
    prof = tmp_path / "logs" / "traced" / "run" / "profile"
    assert f"profiler trace written to {prof}" in capsys.readouterr().out
    assert not (tmp_path / "logs" / "plain" / "run" / "profile").exists()
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    doc = json.load(open(prof / traces[0]))
    names = {e.get("name") for e in doc["traceEvents"]}
    # the traced dispatch ran the step: the LAP's spans and torch ops are in it
    assert {"lap.copy_to_host", "lap.solve"} <= names
    assert any(e.get("cat") == "cpu_op" for e in doc["traceEvents"])
    strip = lambda rows: [{k: v for k, v in r.items() if k != "rays_per_sec"} for r in rows]
    plain, traced = _metrics(tmp_path, "plain"), _metrics(tmp_path, "traced")
    assert [r["step"] for r in traced] == [2, 4, 6]
    assert strip(traced) == strip(plain)
    # the reader takes the CPU trace: no device events, and no error
    assert trace_step.main(["--parse_only", "--out", str(prof), "--steps", "2"]) == 0
    assert "device: none (a trace taken on the CPU)" in capsys.readouterr().out


def test_trace_reader_sums_the_fixture():
    """Every number of the reader on the fixture, worked out by hand from its
    event times (us): 16 device events in 1,180 us over a 2,004 us window,
    busy 1,174 us once the overlaps on two streams are merged; on the host
    7 API calls, 4 torch ops and 2 annotations."""
    s = trace_step.summarize(trace_step.load_trace(trace_step.newest_trace(FIXTURE)))
    approx = lambda x: pytest.approx(x, abs=1e-9)
    assert s["window_ms"] == approx(2.004)
    assert s["device_ms"] == approx(1.180)
    assert s["busy_ms"] == approx(1.174)
    assert s["busy_share"] == approx(1.174 / 2.004)
    want = {"field_forward": (0.400, 2), "field_backward": (0.530, 4),
            "render_field_sigma": (0.050, 1), "render_field_all_f32": (0.070, 1),
            "gemm": (0.040, 1), "sort": (0.030, 1), "reduce": (0.020, 1),
            "elementwise": (0.010, 1), "copy": (0.018, 3), "other": (0.012, 1)}
    assert list(s["by_category"]) == list(want)
    for cat, (ms, n) in want.items():
        assert s["by_category"][cat] == (approx(ms), n), cat
    assert s["launches"] == {"field_forward": 2, "field_backward": 1,
                             "render_field_sigma": 1, "render_field_all_f32": 1}
    assert s["host"]["launch"] == (approx(0.040), 3)
    assert s["host"]["copy or wait"] == (approx(0.225), 3)
    assert s["host"]["other API"] == (approx(0.002), 1)
    assert s["host"]["torch ops outside the API"][0] == approx(0.150)
    assert s["host"]["outside torch ops and the API"][0] == approx(1.587)
    assert s["lap"] == {"lap.copy_to_host": (approx(0.210), 1), "lap.solve": (approx(0.050), 1)}
    # the memcpy waits inside the LAP's span, the sync inside aten::item
    # inside aten::is_nonzero
    assert s["waits_by_op"] == {"lap.copy_to_host": (approx(0.200), 1),
                                "aten::is_nonzero > aten::item": (approx(0.020), 1),
                                "(outside any op)": (approx(0.005), 1)}
    assert s["on_card"]


@pytest.mark.parametrize("name,cat,want", [
    ("void (anonymous namespace)::field_forward_kernel<float>(float const*)", "kernel",
     "field_forward_f32"),
    ("void (anonymous namespace)::field_bwd_tile_kernel<float, 4>(float const*)", "kernel",
     "field_backward_f32"),
    ("void (anonymous namespace)::composite_kernel<__nv_bfloat16, "
     "((anonymous namespace)::Heads)1>(float const*)", "kernel", "render_field_ins"),
    ("void (anonymous namespace)::composite_kernel<float, H_SIGMA>(float const*)", "kernel",
     "render_field_sigma_f32"),
    # the bf16 composites' one template argument, by name or by value
    ("void (anonymous namespace)::composite_kernel<H_ALL>(float const*)", "kernel",
     "render_field_all"),
    ("void (anonymous namespace)::composite_kernel<((anonymous namespace)::Heads)2>"
     "(float const*, int)", "kernel", "render_field_sigma"),
    ("void (anonymous namespace)::composite_kernel<H_INS>(float const*)", "kernel",
     "render_field_ins"),
    # the f32 composites (composite_f32.cuh)
    ("void f32c::composite_f32<(Heads)0>(float const*, float const*)", "kernel",
     "render_field_all_f32"),
    ("void f32c::composite_f32<H_SIGMA>(float const*)", "kernel", "render_field_sigma_f32"),
    ("void f32c::composite_f32<(Heads)1>(float const*)", "kernel", "render_field_ins_f32"),
    # K2 on field_bwd_wgmma.cuh (k2w): its tile pass and dW GEMM
    ("void k2w::field_bwd_tile_kernel<__nv_bfloat16>(float const*, float const*, int, int, "
     "float const*, (anonymous namespace)::Meta, (anonymous namespace)::Layout, k2w::Plan, "
     "float const*, __nv_bfloat16*, __nv_bfloat16*, float*, float*)", "kernel", "field_backward"),
    ("void k2w::dw_partial_kernel<__nv_bfloat16, (anonymous namespace)::Jobs>(CUtensorMap_st, "
     "CUtensorMap_st, float const*, int, int, int, int, (anonymous namespace)::Jobs, float*, int, "
     "float*, int)", "kernel", "field_backward"),
    ("nvjet_tst_128x64_64x8_1x2_h_bz_coopA_NTN", "kernel", "gemm"),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", "copy"),
])
def test_trace_categories(name, cat, want):
    assert trace_step.categorize(name, cat) == want


def test_trace_reader_reads_gzip_and_refuses_a_card_trace_without_device_events(tmp_path,
                                                                                capsys):
    doc = json.load(open(os.path.join(FIXTURE, "fixture.pt.trace.json")))
    with gzip.open(tmp_path / "a.pt.trace.json.gz", "wt") as f:
        json.dump(doc, f)
    assert trace_step.main(["--parse_only", "--out", str(tmp_path), "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "busy 1.174 ms, 58.6% of the window" in out and "field_backward" in out
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e.get("cat") not in trace_step.DEVICE_CATS]
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "b.pt.trace.json").write_text(json.dumps(doc))
    assert trace_step.main(["--parse_only", "--out", str(empty)]) == 1
    assert "holds no device events" in capsys.readouterr().err


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# One step (us): train.step over 0-1000 with its five phases, the LAP's spans
# inside train.loss; five device events; idle 0-55, 58-160, 400-420,
# 425-640, 800-920, 980-1000. Blocking: the DtoH copy (410) and the sync
# (440) in lap.copy_to_host, the autograd thread's sync (700) in
# train.backward; the HtoD copy (50) and the launches do not block.
SPAN_TRACE = {"traceEvents": [
    _ev("train.step", "user_annotation", 0, 1000),
    _ev("train.step", "gpu_user_annotation", 160, 820, tid=7),
    _ev("train.draw", "user_annotation", 0, 100),
    _ev("cudaMemcpyAsync", "cuda_runtime", 50, 10, corr=6),
    _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 55, 3, tid=7, corr=6),
    _ev("train.forward", "user_annotation", 100, 200),
    _ev("cudaLaunchKernel", "cuda_runtime", 150, 5, corr=7),
    _ev("field_forward_kernel<__nv_bfloat16>", "kernel", 160, 240, tid=7, corr=7),
    _ev("train.loss", "user_annotation", 300, 300),
    _ev("lap.copy_to_host", "user_annotation", 400, 50),
    _ev("cudaMemcpyAsync", "cuda_runtime", 410, 30, corr=5),
    _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 420, 5, tid=7, corr=5),
    _ev("cudaStreamSynchronize", "cuda_runtime", 440, 5),
    _ev("lap.solve", "user_annotation", 450, 100),
    _ev("train.backward", "user_annotation", 600, 300),
    _ev("cudaLaunchKernel", "cuda_runtime", 620, 5, corr=8),
    _ev("field_bwd_tile_kernel<__nv_bfloat16, 4>", "kernel", 640, 160, tid=7, corr=8),
    _ev("cudaStreamSynchronize", "cuda_runtime", 700, 20, tid=2),
    _ev("train.optimizer", "user_annotation", 900, 100),
    _ev("cudaLaunchKernel", "cuda_runtime", 910, 5, corr=9),
    _ev("multi_tensor_apply_kernel", "kernel", 920, 60, tid=7, corr=9),
]}
# (calls, host ms, self ms, device-idle ms, blocking calls)
SPAN_WANT = {"train.step": (1, 1.0, 0.0, 0.532, 3), "train.draw": (1, 0.1, 0.1, 0.097, 0),
             "train.forward": (1, 0.2, 0.2, 0.060, 0), "train.loss": (1, 0.3, 0.15, 0.195, 2),
             "lap.copy_to_host": (1, 0.05, 0.05, 0.045, 2), "lap.solve": (1, 0.1, 0.1, 0.1, 0),
             "train.backward": (1, 0.3, 0.3, 0.140, 1),
             "train.optimizer": (1, 0.1, 0.1, 0.040, 0)}


def test_span_table_on_a_hand_made_trace(tmp_path, capsys):
    """trace_step's span table, in the order the spans open: calls, host and
    self time, the device's idle time inside each span and the blocking calls
    that start inside it; the phases' idle sums to the step's."""
    s = trace_step.summarize(SPAN_TRACE)
    assert list(s["spans"]) == list(SPAN_WANT)
    for name, (calls, host, self_, idle, blocking) in SPAN_WANT.items():
        r = s["spans"][name]
        assert (r["calls"], r["blocking"]) == (calls, blocking), name
        for k, v in (("host_ms", host), ("self_ms", self_), ("idle_ms", idle)):
            assert r[k] == pytest.approx(v, abs=1e-9), (name, k)
    phases = ("train.draw", "train.forward", "train.loss", "train.backward", "train.optimizer")
    assert sum(s["spans"][p]["idle_ms"] for p in phases) == pytest.approx(
        s["window_ms"] - s["busy_ms"])
    # the LAP's copy names its phase among the waits
    assert s["waits_by_op"]["train.step > train.loss > lap.copy_to_host"][1] == 2
    # a trace without device events has no idle to read
    cpu = {"traceEvents": [e for e in SPAN_TRACE["traceEvents"]
                           if e["cat"] not in trace_step.DEVICE_CATS + trace_step.API_CATS]}
    assert all(r["idle_ms"] is None for r in trace_step.summarize(cpu)["spans"].values())
    (tmp_path / "s.pt.trace.json").write_text(json.dumps(SPAN_TRACE))
    assert trace_step.main(["--parse_only", "--out", str(tmp_path), "--steps", "1"]) == 0
    rows = {line.split()[0]: line.split()[1:] for line in capsys.readouterr().out.splitlines()
            if line.startswith("  train.") or line.startswith("  lap.")}
    assert rows["train.loss"] == ["1", "0.300", "0.150", "0.195", "2.00"]


@pytest.mark.parametrize("metric,span,value", [
    ("draw_idle_ms.train", "train.draw", 0.097), ("forward_idle_ms.train", "train.forward", 0.060),
    ("loss_idle_ms.train", "train.loss", 0.195), ("backward_idle_ms.train", "train.backward", 0.140),
    ("optimizer_idle_ms.train", "train.optimizer", 0.040), ("host_syncs.train", "train.step", 3),
])
def test_benchmark_span_readers_on_the_hand_made_trace(metric, span, value):
    """benchmark/spans.py and each reader of BENCHMARK.json's span metrics
    agree with trace_step's table, per traced step; without the spans (the
    parent's program) or a traced run each reads nothing."""
    read = harness.layer_reader(metric)
    assert read({"traced": {"steps": 2, "trace": SPAN_TRACE}}) == pytest.approx(value / 2)
    ours = trace_step.summarize(SPAN_TRACE)["spans"][span]
    ix = bench_spans.index({"trace": SPAN_TRACE})
    assert bench_spans.idle_ms(ix, span) == pytest.approx(ours["idle_ms"])
    assert bench_spans.blocking_calls(ix, span) == ours["blocking"]
    bare = {"traceEvents": [e for e in SPAN_TRACE["traceEvents"]
                            if e["cat"] != "user_annotation"]}
    assert read({"traced": {"steps": 2, "trace": bare}}) is None
    cpu = {"traceEvents": [e for e in SPAN_TRACE["traceEvents"]
                           if e["cat"] in ("user_annotation", "cpu_op")]}
    assert read({"traced": {"steps": 2, "trace": cpu}}) is None
    assert read({"untraced": {"steps": 2, "seconds": 1.0}}) is None
    assert harness.layer_reader("view_idle_ms.render")(
        {"traced": {"views": 1, "trace": SPAN_TRACE}}) is None


def test_span_makes_no_record_function_call_without_a_profiler(monkeypatch):
    calls = []
    real = profiling.record_function

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counted)
    for _ in range(3):
        with profiling.span("train.step"):
            pass
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("train.step"):
            pass
    assert calls == ["train.step"]


def _toy_args(**over):
    return default_config(N_train=32, N_samples=4, N_importance=4, near=1.0, far=12.0,
                          perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05, lrate=5e-3,
                          lrate_decay=500, precision="f32", netdepth=2, netwidth=32,
                          multires=2, multires_views=2, N_test=64, **over)


def _spans_of(prof):
    return sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith(("train.", "lap.", "render."))),
                  key=lambda x: (x[0], -x[1]))


def test_train_step_records_one_step_span_with_five_phases_in_order():
    """A plain-path step of a toy config under the CPU profiler, 2 steps:
    each train.step holds draw, forward, loss, backward and optimizer, in
    that order, disjoint and inside it, and both lap.* spans inside the
    loss."""
    scene = make_scene(H=8, W=8, n_train=2, n_test=1)
    args = _toy_args(pallas_train=False, ins_num=scene.ins_num)
    cfg = FieldConfig.from_args(args)
    state = create_train_state(0, cfg, args.lrate, args.lrate_decay)
    scan = make_train_scan_step(args, cfg)
    arrs = scene_arrays(scene, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scan(state, arrs, 1, np.asarray(scene.i_train), 2)
    ev = _spans_of(prof)
    steps = [e for e in ev if e[2] == "train.step"]
    assert len(steps) == 2
    phases = ["train.draw", "train.forward", "train.loss", "train.backward", "train.optimizer"]
    for a, b, _ in steps:
        inside = [e for e in ev if a <= e[0] and e[1] <= b and e[2] != "train.step"]
        kids = [e for e in inside if e[2] in phases]
        assert [e[2] for e in kids] == phases
        assert all(x[1] <= y[0] for x, y in zip(kids, kids[1:]))
        la, lb, _ = kids[2]
        laps = [e for e in inside if e[2].startswith("lap.")]
        assert [e[2] for e in laps] == ["lap.copy_to_host", "lap.solve"]
        assert all(la <= e[0] and e[1] <= lb for e in laps)
    assert len(ev) == 2 * 8


def test_render_many_records_one_view_span_a_view():
    scene = make_scene(H=8, W=8, n_train=1, n_test=2)
    args = _toy_args(ins_num=scene.ins_num)
    cfg = FieldConfig.from_args(args)
    params = {k: DMNeRFField(cfg) for k in ("coarse", "fine")}
    render_im = make_image_renderer(cfg, args, 8, 8, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        views = list(render_im.many(params, scene.K, scene.poses[:2]))
    assert len(views) == 2
    assert [e[2] for e in _spans_of(prof)] == ["render.view"] * 2


def test_check_resume_replay_on_a_resumed_run(tmp_path, capsys):
    """6 steps with a checkpoint at 4 and the final one at 6; the final one
    removed (a kill between them), then --resume to 8 steps: step 6 is
    printed twice with identical metrics (exit 0); one value changed gives
    exit 1."""
    cfg = _config(tmp_path, "res", i_save=4)
    cli_train.main(["--config", cfg, "--device", "cpu"])
    ldir = tmp_path / "logs" / "res" / "run"
    os.remove(ldir / "000006.tar")
    cli_train.main(["--config", cfg, "--device", "cpu", "--resume", "--n_iters", "7"])
    path = ldir / "metrics.jsonl"
    assert [r["step"] for r in _metrics(tmp_path, "res")] == [2, 4, 6, 6, 8]
    assert check_resume_replay.main(str(path)) == 0
    assert "resume replay EXACT over 1 duplicated steps (6..6)" in capsys.readouterr().out
    rows = _metrics(tmp_path, "res")
    rows[3]["psnr_fine"] += 1e-3
    bad = tmp_path / "bad.jsonl"
    bad.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert check_resume_replay.main(str(bad)) == 1
    assert "REPLAY MISMATCH" in capsys.readouterr().out


def test_quality_curve_collects_the_in_training_evals(tmp_path, capsys):
    """An in-training eval at steps 2 and 4 of a 6-step run: collect() gives
    each eval's mean row (the last row of its test_results.txt), and main
    prints one table row per eval."""
    cli_train.main(["--config", _config(tmp_path, "q", i_test=2), "--device", "cpu"])
    ldir = tmp_path / "logs" / "q" / "run"
    rows = quality_curve.collect(str(ldir))
    assert [s for s, _ in rows] == [2, 4]
    for step, row in rows:
        table = np.loadtxt(ldir / f"testset_{step:06d}" / "test_results.txt")
        assert table.shape == (2, 9)
        np.testing.assert_array_equal(row, table[-1])      # LPIPS NaN in both
    capsys.readouterr()
    quality_curve.main([str(ldir)])
    out = capsys.readouterr().out
    assert "1 held-out views" in out and out.count("| 0k |") == 2
    shutil.rmtree(ldir / "testset_000002")
    shutil.rmtree(ldir / "testset_000004")
    with pytest.raises(SystemExit):
        quality_curve.main([str(ldir)])


@pytest.mark.parametrize("name", [
    "void k2w::field_bwd_tile_kernel<__nv_bfloat16>(float const*, float const*, int, int)",
    "void k2w::dw_partial_kernel<__nv_bfloat16, (anonymous namespace)::Jobs>(CUtensorMap_st)",
    "void (anonymous namespace)::field_bwd_tile_kernel<__nv_bfloat16, 32>(float const*)",
    "void (anonymous namespace)::dw_partial_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)",
    "reduce_splits_kernel(float const*, int, int, float*)",
])
def test_k2_kernels_count_as_field_backward_in_the_benchmark(name):
    """Each kernel of the bf16 K2, on either core, is what the benchmark's
    k2_roofline.train pattern and its trace reader count as K2, and what
    trace_step files under field_backward."""
    import importlib.util

    from benchmark import trace_summary
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "layer_metrics", "k2_roofline.train.py")
    spec = importlib.util.spec_from_file_location("k2_roofline_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.PATTERN.search(name)
    assert trace_summary.categorize(name) == trace_step.categorize(name) == "field_backward"


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_bench_workload_is_bench_pys_train_workload(precision):
    """trace_step.bench_workload, the train workload that trace_step's
    capture and chip_smoke.py's rank phases run: 3072 rays, 64+128 samples,
    two 8x256 fields at PE 10/4 on the kernels, the penalizer and perturb
    on, the field's compute dtype from the precision, 4 train views at
    128x128, and K=32: the boxroom labels subdivided 8 ways, every value in
    some view."""
    import torch

    args, scene, cfg = trace_step.bench_workload(precision)
    assert (args.N_train, args.N_samples, args.N_importance) == (3072, 64, 128)
    assert (args.netdepth, args.netwidth, args.multires, args.multires_views) == (8, 256, 10, 4)
    assert args.penalize and args.perturb > 0 and args.pallas_train
    assert (args.tolerance, args.deta_w, args.lrate, args.lrate_decay) == (0.05, 0.05, 5e-4, 500)
    assert (cfg.netdepth, cfg.netwidth, cfg.ins_num) == (8, 256, 32)
    assert cfg.compute_dtype == {"bf16": torch.bfloat16, "f32": torch.float32}[precision]
    assert list(scene.i_train) == [0, 1, 2, 3] and (scene.H, scene.W) == (128, 128)
    assert scene.images.shape[1:3] == (128, 128)
    assert np.array_equal(np.unique(scene.gt_labels), np.arange(32))
