# Ported from dmnerf_tpu/parallel/mesh.py (the 1-D ray mesh on torch.distributed; make_mesh_2d and shard_params_model are not ported).
"""The ray mesh: one process per card, the ray batch split over the processes.

The JAX package shards rays over a 1-D ('data',) device mesh and keeps
global semantics: XLA inserts the psums, and a step over R devices computes
the single-device step. PyTorch inserts none, so here every cross-ray
reduction is an explicit collective, and a run over R ranks gives the result
of one rank up to the order of fp32 sums:

- every rank draws the step's global randomness and takes its contiguous
  rows of the ray batch (shard_batch);
- loss statistics are summed across ranks by psum, whose value is the global
  sum and whose gradient flows to this rank's own rows, so every rank
  computes the same global loss;
- after backward, all_reduce_grads sums the parameters' gradients (the loss
  is already global, so the sum is the whole gradient), and every rank takes
  the same Adam step;
- rendered rows come back together by gather.

A DataMesh is this process's rank, the world size, its device and its
process group. Under torchrun (`python -m torch.distributed.run`, which sets
WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) make_mesh builds
one. Backend: NCCL for CUDA devices, gloo for the CPU, or gloo on CUDA
tensors when the caller asks (several ranks on one card). gloo stages CUDA
tensors through the host for all_reduce and broadcast and has no CUDA
all_gather, so gather is an all_reduce of a zero-filled buffer in which each
rank fills its own rows (x + 0 == x). Nothing falls back to another device
or backend. The 2-D (data, model) mesh and its tensor-parallel parameter
shardings are not ported: at ~1.4 M parameters they are no gain.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataMesh:
    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None     # None: the default group

    def rows(self, n: int, what: str = "rows") -> slice:
        """This rank's contiguous rows of a leading axis of n; raises, naming
        `what` and the world size, unless n splits evenly over the ranks."""
        if n % self.size:
            raise ValueError(f"{what} {n} does not split over the world size {self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def rank_share(n: int, mesh: Optional[DataMesh], what: str) -> int:
    """This rank's share of n (n itself without a mesh); see DataMesh.rows."""
    if mesh is None:
        return n
    rows = mesh.rows(n, what)
    return rows.stop - rows.start


def launched() -> bool:
    """Whether torchrun (or a caller setting its variables) started this process."""
    return "WORLD_SIZE" in os.environ


def check_data_devices(n_devices: int, world_size: int) -> int:
    """--data_devices against the launched ranks: 0 means all of them."""
    if n_devices and n_devices != world_size:
        raise ValueError(f"--data_devices {n_devices} does not match the world size "
                         f"{world_size} that torchrun launched (0 = all launched ranks)")
    return world_size


def mesh_device(device, local_rank: int) -> torch.device:
    """`cuda` is cuda:{local_rank}; an explicit cuda:N is used as given; a
    card that is not there raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if device.index is None:
        device = torch.device("cuda", local_rank)
    if not torch.cuda.is_available() or device.index >= torch.cuda.device_count():
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RuntimeError(f"rank device {device}: this machine has {n} CUDA devices")
    return device


def make_mesh(n_devices: int = 0, device="cuda", backend: Optional[str] = None) -> DataMesh:
    """The 1-D data mesh over the ranks torchrun launched (n_devices 0 = all;
    any other count must equal the world size). Initialises the default
    process group from torchrun's variables unless it is up already.
    backend: nccl (CUDA) or gloo (CPU, or CUDA when asked)."""
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    check_data_devices(n_devices, world)
    device = mesh_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and device.type != "cuda"):
        raise ValueError(f"backend {backend!r} cannot run on {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    if (dist.get_world_size(), dist.get_rank(), dist.get_backend()) != (world, rank, backend):
        raise RuntimeError(f"the process group is up as rank {dist.get_rank()} of "
                           f"{dist.get_world_size()} on {dist.get_backend()}, not rank {rank} "
                           f"of {world} on {backend}")
    return DataMesh(rank, world, device)


def close_mesh(mesh: Optional[DataMesh]) -> None:
    if mesh is not None and dist.is_initialized():
        barrier(mesh)
        dist.destroy_process_group()


def is_main(mesh: Optional[DataMesh]) -> bool:
    """Rank 0 (or no mesh): the rank that prints and writes."""
    return mesh is None or mesh.rank == 0


def _tree(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(fn, v) for v in x)
    return None if x is None else fn(x)


def shard_batch(x, mesh: Optional[DataMesh]):
    """This rank's contiguous slice of the leading axis of every tensor in x
    (a tensor or a tuple / list of them); x itself without a mesh."""
    if mesh is None:
        return x
    return _tree(lambda t: t[mesh.rows(t.shape[0])], x)


def put_sharded(x, mesh: DataMesh):
    """Host arrays -> this rank's rows of their leading axis on the mesh's device."""
    return _tree(lambda t: torch.as_tensor(t)[mesh.rows(len(t))].to(mesh.device), x)


def replicate(x, mesh: Optional[DataMesh]):
    """Rank 0's values into every rank's tensors of x, in place (broadcast)."""
    if mesh is not None:
        _tree(lambda t: dist.broadcast(t, src=0, group=mesh.group), x)
    return x


def put_replicated(x, mesh: DataMesh):
    """Host arrays -> rank 0's values on every rank's device."""
    return replicate(_tree(lambda t: torch.as_tensor(t).to(mesh.device).contiguous(), x), mesh)


def gather(x, mesh: Optional[DataMesh]):
    """The whole array on every rank from each rank's contiguous rows of its
    leading axis (tensors or a tuple / list of them)."""
    if mesh is None:
        return x

    def one(t):
        whole = t.new_zeros((t.shape[0] * mesh.size,) + tuple(t.shape[1:]))
        whole[mesh.rank * t.shape[0]:(mesh.rank + 1) * t.shape[0]] = t
        dist.all_reduce(whole, group=mesh.group)
        return whole

    return _tree(one, x)


class _PSum(torch.autograd.Function):
    """Sum over ranks; the gradient passes to this rank's operand as it is."""

    @staticmethod
    def forward(ctx, x, group):
        y = torch.clone(x, memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """The sum of x over the ranks (x itself without a mesh). Differentiable:
    every rank computes the same loss from the sum, so dL/dx on this rank is
    dL/dsum, the local part of the global gradient."""
    return x if mesh is None else _PSum.apply(x, mesh.group)


def all_reduce_grads(params, mesh: DataMesh) -> None:
    """Sum the parameters' .grad over the ranks, in one flat buffer."""
    grads = [p.grad for p in params]
    if any(g is None for g in grads):
        raise RuntimeError("all_reduce_grads: a parameter has no gradient")
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def broadcast_object(obj, mesh: Optional[DataMesh]):
    """Rank 0's picklable obj on every rank."""
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group, device=mesh.device)
    return box[0]


def barrier(mesh: Optional[DataMesh]) -> None:
    """Wait on the host until every rank got here (an all_reduce, which both
    backends run on the mesh's device)."""
    if mesh is not None:
        flag = torch.zeros(1, device=mesh.device)
        dist.all_reduce(flag, group=mesh.group)
        flag.item()
