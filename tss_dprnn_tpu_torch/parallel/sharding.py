"""Collectives of the data axis (counterpart of the data half of
``tss_dprnn_tpu/parallel/sharding.py``).

JAX replicates the weights over the mesh and shards each batch's axis 0
over ``data``; XLA then reduces what the step reduces. Here the weights are
replicated by ``DistributedDataParallel``'s broadcast at construction, each
loader hands its process its own rows (``data/loader.py``), and what a
step or an epoch reduces over the global batch goes through these helpers.
Each is a no-op for one process: a world of size 1 takes no collective.

A collective of card tensors runs on the card under NCCL and on the CPU
under gloo (which also takes CUDA tensors); host values (metric sums, the
references' length, eval rows) go through gloo on the CPU, beside NCCL
through its own group (``mesh.host_group``), so that no host number waits
for the card's queue. A failed collective raises.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch
import torch.distributed as dist

from tss_dprnn_tpu_torch.parallel.mesh import host_group, process_count


def mean_over_processes(value: torch.Tensor) -> torch.Tensor:
    """The mean of ``value`` over the processes (a loss: each process holds
    the mean over its equal share of the rows, so this is the global
    batch's mean)."""
    world = process_count()
    if world == 1:
        return value
    out = value.detach().clone()
    dist.all_reduce(out)
    return out / world


def sum_numbers_over_processes(values: Sequence[float]) -> List[float]:
    """Host numbers (metric sums and counts) summed over the processes, in
    float64."""
    if process_count() == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.all_reduce(t, group=host_group())
    return t.tolist()


def gather_objects(obj: Any) -> List[Any]:
    """Every process's ``obj`` (picklable), in rank order, on every process."""
    world = process_count()
    if world == 1:
        return [obj]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, obj, group=host_group())
    return out


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def longest_over_processes(n: int) -> int:
    """The largest of the processes' ``n``: the length one process pads the
    global batch's references to when it collates them whole (BatchNorm's
    statistics count the padded frames)."""
    if process_count() == 1:
        return n
    t = torch.tensor([n], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return int(t)


class _SummedOverProcesses(torch.autograd.Function):
    """The sum of a tensor over the processes; its gradient is the sum of
    the processes' gradients, since every process's loss reads the sum."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def differentiable_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the processes (BatchNorm's global
    statistics); ``x`` itself for one process."""
    if process_count() == 1:
        return x
    return _SummedOverProcesses.apply(x)
