# Ported from dmnerf_tpu/utils/profiling.py (trace on torch.profiler; span added; ThroughputMeter left out, nothing in the port reads it).
"""Profiling and observability helpers.

The reference has no tracing (only per-image wall-clock prints). Here:
torch.profiler trace capture around training windows, written as a
Chrome/Perfetto trace (`*.pt.trace.json`, readable by
`python -m dmnerf_torch.tools.trace_step --parse_only --out DIR`), and the
program's spans on torch.profiler's clock.

Spans (`span`), each read by `tools/trace_step.py`'s span table and by the
benchmark's per-layer metrics:
- `train.step` (train/step.py::make_train_scan_step), one a step, and its
  five disjoint children in order: `train.draw` (the step's randomness,
  pixels, rays, targets and their shard), `train.forward` (render_rays: both
  fields and the importance sampling), `train.loss` (photometric, instance
  and penalizer; `lap.copy_to_host` and `lap.solve` inside it, from
  losses/instance.py), `train.backward` (the gradients set to none, then
  backward) and `train.optimizer` (the mesh's gradient sum, Adam and its
  schedule);
- `render.view` (eval/renderer.py::make_image_renderer's render_im_dev):
  one view's rays, chunk launches, label reduction and the start of its copy
  to the host;
- `edit.view` (edit/runner.py::_prefetch_map, under manipulator_eval,
  eval_views and manipulator_demo): one whole-image edit, its rays and
  padding, every chunk, the label reductions and the start of its copy; in
  each chunk (edit/manipulator.py::manipulate_chunk) disjoint children in
  the order of the chain: `edit.coarse` (the coarse fields and composites),
  `edit.resample` (the first sample_pdf and the accumulated-label unions),
  `edit.accum` (the fine accumulated-label passes, K5), `edit.exchange` (the
  first exchanger and the re-composite), `edit.resample` (the second
  sample_pdf and the fine union), `edit.fine` (the fine fields),
  `edit.exchange` (the second exchanger) and `edit.fine` (the final
  composite).
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A torch.profiler span `name` (record_function) while a profiler is
    running, else a no-op that makes no dispatcher call: a span costs one
    check when nothing traces."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF


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
