"""loss_idle_ms.train: milliseconds per traced step in which the card sat idle
while the host was inside the step's `train.loss` span
(dmnerf_torch/train/step.py: the photometric, instance and penalizer losses,
with the host LAP's spans inside it); benchmark/spans.py."""

from benchmark import spans


def read(ctx):
    return spans.per(ctx, "steps", spans.idle_ms, "train.loss")
