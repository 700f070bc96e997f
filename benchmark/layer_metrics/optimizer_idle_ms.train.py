"""optimizer_idle_ms.train: milliseconds per traced step in which the card sat
idle while the host was inside the step's `train.optimizer` span
(dmnerf_torch/train/step.py: the mesh's gradient sum, Adam's step and its
schedule); benchmark/spans.py."""

from benchmark import spans


def read(ctx):
    return spans.per(ctx, "steps", spans.idle_ms, "train.optimizer")
