"""host_syncs.train: blocking CUDA API calls per traced step inside the
program's `train.step` spans (dmnerf_torch/train/step.py::
make_train_scan_step): every *Synchronize, and every cudaMemcpy* whose copy
runs device to host; benchmark/spans.py."""

from benchmark import spans


def read(ctx):
    return spans.per(ctx, "steps", spans.blocking_calls, "train.step")
