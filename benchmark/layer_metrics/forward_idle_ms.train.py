"""forward_idle_ms.train: milliseconds per traced step in which the card sat
idle while the host was inside the step's `train.forward` span
(dmnerf_torch/train/step.py: core/rendering.py::render_rays, both fields
through K1 and the importance sampling); benchmark/spans.py."""

from benchmark import spans


def read(ctx):
    return spans.per(ctx, "steps", spans.idle_ms, "train.forward")
