"""The port's profiling and run-record tools on the CPU: `cli.train
--profile_steps` writes a torch.profiler trace and the same metrics as an
untraced run; trace_step's reader on a committed Chrome-trace fixture with
known durations (tests/torch_golden/trace/fixture.pt.trace.json);
ThroughputMeter; check_resume_replay on a resumed run's metrics.jsonl; and
quality_curve on a run's in-training evals."""

import gzip
import json
import os
import shutil

import numpy as np
import pytest

from dmnerf_torch.cli import train as cli_train
from dmnerf_torch.tools import check_resume_replay, quality_curve, trace_step
from dmnerf_torch.utils.profiling import ThroughputMeter

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


def test_throughput_meter():
    m = ThroughputMeter()
    m.update(100)
    m.update(100)
    assert m.rays_per_sec > 0
    assert m.ms_per_step > 0
    m.reset()
    assert m._steps == 0


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
