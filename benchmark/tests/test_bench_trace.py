"""The benchmark's frozen trace reader on a small synthetic Chrome trace:
its sums agree with each other and with the port's own reader, and the
breakdown names what the host was doing while the card sat idle."""

import pytest

from benchmark import trace_summary

K1 = "void (anonymous namespace)::field_forward_kernel<__nv_bfloat16>(float const*)"
K3 = "void (anonymous namespace)::composite_kernel<((anonymous namespace)::Heads)0>(float const*)"


def ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


TRACE = {"traceEvents": [
    ev("train_step", "user_annotation", 0, 1000),
    ev("aten::mm", "cpu_op", 10, 100),
    ev("cudaLaunchKernel", "cuda_runtime", 20, 10),
    ev(K1, "kernel", 100, 300, tid=7),
    ev(K3, "kernel", 450, 100, tid=7),
    ev("lap.copy_to_host", "user_annotation", 600, 100),
    ev("cudaMemcpyAsync", "cuda_runtime", 610, 50),
    ev("Memcpy DtoH", "gpu_memcpy", 620, 20, tid=7),
    ev("lap.solve", "user_annotation", 720, 200),
]}


def test_summary_sums_agree():
    s = trace_summary.summarize(TRACE)
    assert s["window_ms"] == pytest.approx(1.0)
    assert s["busy_ms"] == pytest.approx(0.42)
    assert s["device_ms"] == pytest.approx(sum(v[0] for v in s["by_category"].values()))
    assert s["by_category"]["field_forward"] == (pytest.approx(0.3), 1)
    assert s["by_category"]["copy"] == (pytest.approx(0.02), 1)
    assert s["host"]["copy or wait"] == (pytest.approx(0.05), 1)
    assert s["host"]["launch"] == (pytest.approx(0.01), 1)
    assert s["lap"]["lap.solve"] == (pytest.approx(0.2), 1)
    assert trace_summary.summarize(TRACE) == s


def test_agrees_with_the_port_reader():
    from dmnerf_torch.tools import trace_step

    ours, theirs = trace_summary.summarize(TRACE), trace_step.summarize(TRACE)
    for k in ("window_ms", "device_ms", "busy_ms", "busy_share", "by_name", "host", "lap"):
        assert ours[k] == theirs[k], k


def test_breakdown_names_the_host_during_idle_gaps():
    b = trace_summary.breakdown(TRACE)
    assert b["device_ops"][0] == [K1, pytest.approx(3e-4)]
    idle = dict(b["idle_gaps"])
    # 0-100 (an mm launching), 400-450, 550-620, 640-1000 (the LAP's solve)
    assert sum(idle.values()) == pytest.approx(0.58e-3)
    assert idle["train_step > lap.solve"] == pytest.approx(0.36e-3)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
