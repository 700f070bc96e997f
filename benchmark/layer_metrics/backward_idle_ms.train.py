"""backward_idle_ms.train: milliseconds per traced step in which the card sat
idle while the host was inside the step's `train.backward` span
(dmnerf_torch/train/step.py: the gradients set to none and total.backward(),
the autograd thread's work included); benchmark/spans.py."""

from benchmark import spans


def read(ctx):
    return spans.per(ctx, "steps", spans.idle_ms, "train.backward")
