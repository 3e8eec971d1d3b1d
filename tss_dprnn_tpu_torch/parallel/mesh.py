"""The process group and its mesh: one process per card (counterpart of
``tss_dprnn_tpu/parallel/mesh.py``: ``initialize_distributed`` and
``make_mesh``).

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

:func:`make_mesh` lays the group out as JAX's ``Mesh`` with axes ('data',
'model'): rank r sits at ``divmod(r, model)``, so a model group is
consecutive ranks (the cards of one host). Unlike JAX, which drops surplus
devices, ``data * model`` must equal the world size: a process left out
would idle.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_joins = 0  # the groups this process has joined
# a gloo group over the same processes for host values, under NCCL: a host
# number reduced through NCCL would wait for the card's queue to drain
_host_group: Optional[dist.ProcessGroup] = None
# the mesh whose sharded forward (or backward) runs: its data axis is the
# one BatchNorm's statistics sum over (``sharding.ShardedParameters.full``)
_current_mesh: Optional["Mesh"] = None


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


class Mesh:
    """A data x model layout of the process group (counterpart of JAX's
    ``Mesh(devices.reshape(data, model), ("data", "model"))``).

    ``data_group`` holds the processes of this process's model index (the
    ones that split a batch's rows), ``model_group`` those of its data index
    (the ones that split the sharded parameters and see the same rows);
    ``data_host_group`` is the data group for host values (gloo beside NCCL).
    With ``model`` 1 the data group is the whole group and the three are
    None (the default group; :func:`host_group` for host values), as without
    a mesh."""

    def __init__(self, data: int, model: int, rank: int,
                 data_group: Optional[dist.ProcessGroup] = None,
                 model_group: Optional[dist.ProcessGroup] = None,
                 data_host_group: Optional[dist.ProcessGroup] = None):
        self.data, self.model = int(data), int(model)
        self.data_index, self.model_index = divmod(int(rank), self.model)
        self.data_group, self.model_group = data_group, model_group
        self.data_host_group = data_host_group if model > 1 else host_group()

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, data_index={self.data_index}, "
                f"model_index={self.model_index})")


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The mesh of the joined process group (one process without one):
    ``data`` defaults to ``world // model``; ``data * model`` must equal the
    world size, or this raises. Every process must call it, with the same
    arguments: each of the groups is made by all of them (under the join's
    rendezvous prefix, which the default group's store carries)."""
    world, rank = process_count(), process_index()
    model = int(model)
    if model < 1:
        raise ValueError(f"model axis {model} must be >= 1")
    if data is None:
        data = world // model
    data = int(data)
    if data < 1 or data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes, the process "
                         f"group has {world}: data * model must equal the world size (the "
                         "JAX package drops surplus devices; a process cannot be left idle)")
    if model == 1:
        return Mesh(data, 1, rank)
    ranks = np.arange(world).reshape(data, model)
    separate_host = dist.get_backend() != "gloo"
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    # every process makes every group, in the same order
    for m in range(model):
        members = ranks[:, m].tolist()
        g = dist.new_group(members)
        h = dist.new_group(members, backend="gloo") if separate_host else g
        if rank in members:
            groups.update(data=g, host=h)
    for d in range(data):
        members = ranks[d].tolist()
        g = dist.new_group(members)
        if rank in members:
            groups["model"] = g
    mesh = Mesh(data, model, rank, groups["data"], groups["model"], groups["host"])
    logger.info("mesh %s of %d processes: %r", mesh.shape, world, mesh)
    return mesh


def current_mesh() -> Optional[Mesh]:
    """The mesh whose sharded model is running, else None."""
    return _current_mesh


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[None]:
    """Run the block with ``mesh`` as :func:`current_mesh`."""
    global _current_mesh
    previous, _current_mesh = _current_mesh, mesh
    try:
        yield
    finally:
        _current_mesh = previous


def data_count(mesh: Optional[Mesh] = None) -> int:
    """The data axis's size: ``mesh``'s, else the running sharded model's
    mesh's, else the world size."""
    mesh = mesh if mesh is not None else _current_mesh
    return mesh.data if mesh is not None else process_count()
