# Ported from dmnerf_tpu/utils/profiling.py (trace on torch.profiler; ThroughputMeter copied as it is).
"""Profiling and observability helpers.

The reference has no tracing (only per-image wall-clock prints). Here:
torch.profiler trace capture around training windows, written as a
Chrome/Perfetto trace (`*.pt.trace.json`, readable by
`python -m dmnerf_torch.tools.trace_step --parse_only --out DIR`), and a
windowed throughput meter.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, device):
    """Capture a torch.profiler trace of the block into log_dir: CPU activity
    always, CUDA activity (kernels, copies, memsets) when `device` is a CUDA
    device. The device is synchronised before the profiler stops, so every
    kernel the block launched is in the trace."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)


class ThroughputMeter:
    """Windowed rays/sec + step-time tracker."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._rays = 0
        self._steps = 0

    def update(self, n_rays: int):
        self._rays += n_rays
        self._steps += 1

    @property
    def rays_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._rays / dt if dt > 0 else 0.0

    @property
    def ms_per_step(self) -> float:
        dt = time.perf_counter() - self._t0
        return 1000.0 * dt / self._steps if self._steps else 0.0
