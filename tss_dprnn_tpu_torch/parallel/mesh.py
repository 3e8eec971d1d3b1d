"""The process group: one process per card (counterpart of
``tss_dprnn_tpu/parallel/mesh.py``'s ``initialize_distributed`` and its
``data`` axis).

``python -m torch.distributed.run --nproc_per_node W`` starts W processes
and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in each; :func:`initialize_distributed` reads them, or takes
the coordinator's ``host:port`` and this process's place explicitly, as the
JAX package's ``jax.distributed`` keys give them (``utils/config.
distributed_args``). The backend follows the device: NCCL on the card, gloo
on the CPU. A failed initialisation raises; nothing falls back to one
process.

:func:`process_index` and :func:`process_count` keep the JAX names, so the
loaders read as the JAX ones do; without a group they are (0, 1).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_joins = 0  # the groups this process has joined
# a gloo group over the same processes for host values, under NCCL: a host
# number reduced through NCCL would wait for the card's queue to drain
_host_group: Optional[dist.ProcessGroup] = None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: Optional[Union[str, torch.device]] = None) -> None:
    """Join the process group, once per process, before any collective.

    Without ``coordinator_address`` the group comes from torchrun's
    environment (``env://``); with it, from ``tcp://coordinator_address``
    with ``num_processes`` and ``process_id``. ``backend`` defaults to the
    device's: ``nccl`` for the card (``device`` None or a CUDA device),
    ``gloo`` for the CPU. An explicit ``backend`` is for callers that need
    another one, such as two processes sharing one card through gloo."""
    global _joins, _host_group
    if backend is None:
        kind = "cuda" if device is None else torch.device(device).type
        backend = "nccl" if kind == "cuda" else "gloo"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA card; pass --device cpu (gloo) to run "
                           "the processes on the CPU")
    if coordinator_address is None:
        url, place = "env://", {}
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        url = f"tcp://{coordinator_address}"
        place = dict(world_size=int(num_processes), rank=int(process_id))
    store, rank, world = next(dist.rendezvous(url, **place))
    # the rendezvous store outlives a group (torchrun's agent holds it), so a
    # group joined after another left would read the keys the last one
    # wrote, gloo's addresses among them, and connect to closed sockets:
    # every join writes under its own prefix (each process joins the same
    # groups in the same order, so the prefixes agree)
    _joins += 1
    dist.init_process_group(backend, store=dist.PrefixStore(f"join{_joins}/", store),
                            rank=rank, world_size=world)
    _host_group = dist.new_group(backend="gloo") if backend == "nccl" and world > 1 else None
    logger.info("process group: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(),
                backend)


def join_group(args: Optional[Dict[str, Any]],
               device: Optional[Union[str, torch.device]] = None) -> bool:
    """Join the group that ``args`` (``utils/config.distributed_args``) or
    torchrun's environment describe, unless one is joined already. True when
    this call joined it, so that the caller leaves it at its end."""
    if is_distributed() or (args is None and "WORLD_SIZE" not in os.environ):
        return False
    initialize_distributed(**(args or {}), device=device)
    return True


def leave_group() -> None:
    """Leave the process group, after a barrier."""
    global _host_group
    if is_distributed():
        dist.barrier()
        dist.destroy_process_group()
        _host_group = None


def host_group() -> Optional[dist.ProcessGroup]:
    """The group that reduces host values without the card: the gloo group
    beside NCCL, else None (the default group, which is gloo)."""
    return _host_group


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    """This process's place among those of its host: ``LOCAL_RANK`` as
    torchrun sets it, else 0."""
    return int(os.environ.get("LOCAL_RANK", 0))
