"""draw_idle_ms.train: milliseconds per traced step in which the card sat idle
while the host was inside the step's `train.draw` span
(dmnerf_torch/train/step.py: the step's randomness, then make_train_step's
draw of its pixels, rays and targets); benchmark/spans.py."""

from benchmark import spans


def read(ctx):
    return spans.per(ctx, "steps", spans.idle_ms, "train.draw")
