"""Collectives of the data axis and the sharded parameters of the model
axis (counterpart of ``tss_dprnn_tpu/parallel/sharding.py``).

Data axis. JAX replicates the weights over the mesh and shards each batch's
axis 0 over ``data``; XLA then reduces what the step reduces. Here the
weights are replicated by ``DistributedDataParallel``'s broadcast at
construction (or, under a model axis, by :class:`ShardedParameters`), each
loader hands its process its own rows (``data/loader.py``), and what a step
or an epoch reduces over the global batch goes through these helpers, over
the data group of the ``mesh`` they are given (or of the mesh whose sharded
model runs, ``mesh.current_mesh``), else over the whole group. Each is a
no-op when the data axis has one process: it takes no collective.

A collective of card tensors runs on the card under NCCL and on the CPU
under gloo (which also takes CUDA tensors, for ``broadcast`` and
``all_reduce`` only); host values (metric sums, the references' length,
eval rows) go through gloo on the CPU, beside NCCL through its own group
(``mesh.host_group``, ``Mesh.data_host_group``), so that no host number
waits for the card's queue. A failed collective raises.

Model axis. ``DEFAULT_TP_RULES`` name, in the port's ``state_dict`` names,
the parameters that JAX's rules shard over ``model``, with the torch
tensor's dimension that holds JAX's sharded one (after
``utils/weights.state_dict_from_jax``'s transposes): the LSTMs' gate rows,
the block Denses' input columns, the mask, out and gate heads' output rows.
:class:`ShardedParameters` keeps this process's slice of each (so Adam's
moments are slices too, as optax's ``mu`` / ``nu`` mirrors are) and
gathers the whole tensors before the model runs, with a backward that hands
each slice its part of the gradient. GSPMD would also partition the dense
heads' products; here every op runs on the gathered weights, the same
function with no activation collective.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tss_dprnn_tpu_torch.parallel.mesh import (Mesh, current_mesh, host_group, process_count,
                                                use_mesh)


def _data_axis(mesh: Optional[Mesh]):
    """(group, host group, size) of the data axis of ``mesh``, else of the
    running sharded model's mesh, else of the whole group."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None, host_group(), process_count()
    return mesh.data_group, mesh.data_host_group, mesh.data


def mean_over_processes(value: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The mean of ``value`` over the data axis (a loss: each process holds
    the mean over its equal share of the rows, so this is the global
    batch's mean)."""
    group, _, n = _data_axis(mesh)
    if n == 1:
        return value
    out = value.detach().clone()
    dist.all_reduce(out, group=group)
    return out / n


def sum_numbers_over_processes(values: Sequence[float],
                               mesh: Optional[Mesh] = None) -> List[float]:
    """Host numbers (metric sums and counts) summed over the data axis, in
    float64."""
    _, group, n = _data_axis(mesh)
    if n == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.all_reduce(t, group=group)
    return t.tolist()


def gather_objects(obj: Any, mesh: Optional[Mesh] = None) -> List[Any]:
    """Every data index's ``obj`` (picklable), in data order, on every
    process."""
    _, group, n = _data_axis(mesh)
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def longest_over_processes(n: int, mesh: Optional[Mesh] = None) -> int:
    """The largest of the data axis's ``n``: the length one process pads
    the global batch's references to when it collates them whole
    (BatchNorm's statistics count the padded frames)."""
    _, group, size = _data_axis(mesh)
    if size == 1:
        return n
    t = torch.tensor([n], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t)


class _SummedOverProcesses(torch.autograd.Function):
    """The sum of a tensor over a group; its gradient is the sum of the
    group's gradients, since every process's loss reads the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def differentiable_sum(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the data axis (BatchNorm's global
    statistics); ``x`` itself when the axis has one process."""
    group, _, n = _data_axis(mesh)
    if n == 1:
        return x
    return _SummedOverProcesses.apply(x, group)



# ---------------------------------------------------------------- model axis

# (state_dict name regex, the torch tensor's sharded dimension): JAX's
# DEFAULT_TP_RULES (sharding.py:19-26) in the port's names. The biases of the
# dense heads stay replicated, as there.
DEFAULT_TP_RULES: List[Tuple[str, int]] = [
    # LSTM (GRU, RNN) input / hidden projections: the fused gate rows
    (r"(.*\.)?(weight_ih|weight_hh|bias_ih|bias_hh)_l0(_reverse)?", 0),
    # the wide 1x1 heads: mask_dense, out_dense, gate_dense (output rows)
    (r"(.*\.)?separation\.(conv2d|out\.0|gate\.0)\.weight", 0),
    # the blocks' Denses after the BiLSTMs: their input columns
    (r"(.*\.)?(intra|inter)_linear\.weight", 1),
]


def param_placements(module: torch.nn.Module, mesh: Optional[Mesh],
                     rules: Optional[Sequence[Tuple[str, int]]] = None
                     ) -> Dict[str, Optional[int]]:
    """Each parameter's sharded dimension over ``mesh``'s model axis, by
    name (None: replicated); all None without a mesh or with a model axis of
    1 (counterpart of ``param_shardings``)."""
    rules = DEFAULT_TP_RULES if rules is None else rules
    tp = mesh is not None and mesh.model > 1
    out: Dict[str, Optional[int]] = {}
    for name, p in module.named_parameters():
        out[name] = None
        if tp:
            for pattern, dim in rules:
                if re.fullmatch(pattern, name) and dim < p.ndim:
                    out[name] = dim
                    break
    return out


def shard_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of part ``index`` of ``n`` split into ``parts`` (the first
    ``n % parts`` parts one longer, as ``torch.tensor_split``)."""
    q, r = divmod(n, parts)
    lo = index * q + min(index, r)
    return lo, lo + q + (index < r)


class _Slot:
    """A sharded parameter: its owner module and attribute, its whole
    shape and dimension, and this process's [lo, hi) along it."""

    def __init__(self, name, owner, attr, shape, dim, lo, hi):
        self.name, self.owner, self.attr = name, owner, attr
        self.shape, self.dim, self.lo, self.hi = tuple(shape), dim, lo, hi
        self.numel = int(torch.Size(shape).numel())

    def part(self, full: torch.Tensor) -> torch.Tensor:
        return full.narrow(self.dim, self.lo, self.hi - self.lo)


def _assemble(slots: Sequence[_Slot], shards: Sequence[torch.Tensor],
              group: dist.ProcessGroup) -> List[torch.Tensor]:
    """The whole tensors of ``shards`` over the model group, as views of one
    buffer: each process writes its slices into zeros and one all-reduce
    sums them (adding zeros is exact). ``all_reduce`` is the one collective
    that both NCCL and gloo on CUDA tensors take."""
    if not slots:
        return []
    dtypes = {t.dtype for t in shards}
    if len(dtypes) != 1:
        raise TypeError(f"sharded tensors of several dtypes {sorted(map(str, dtypes))}")
    flat = shards[0].new_zeros(sum(s.numel for s in slots))
    views, off = [], 0
    for s, t in zip(slots, shards):
        view = flat[off:off + s.numel].view(s.shape)
        s.part(view).copy_(t)
        views.append(view)
        off += s.numel
    dist.all_reduce(flat, group=group)
    return views


class _Gathered(torch.autograd.Function):
    """Whole tensors from this process's shards; the backward hands each
    shard its slice of the whole tensor's gradient. Not a sum over the model
    group: every member computes the same loss on the same rows."""

    @staticmethod
    def forward(ctx, sharded, *shards):
        ctx.slots = sharded.slots
        return tuple(_assemble(sharded.slots, shards, sharded.mesh.model_group))

    @staticmethod
    def backward(ctx, *grads):
        # copies: two whole gradients may be one tensor (b_ih and b_hh
        # reach the loss through their sum), and a slice of it would become
        # both parameters' .grad, which the clip then scales twice
        return (None,) + tuple(None if g is None else
                               s.part(g).clone(memory_format=torch.contiguous_format)
                               for s, g in zip(ctx.slots, grads))


class ShardedParameters:
    """``module``'s parameters placed over ``mesh``'s model axis by
    ``DEFAULT_TP_RULES``: each matched ``nn.Parameter`` is replaced by this
    process's slice of it (:func:`shard_bounds` along its dimension), so an optimizer
    built afterwards keeps slice-shaped moments. First every parameter and
    buffer is broadcast from rank 0, as DDP does at construction.

    The model runs inside :meth:`full`, which gathers the whole tensors into
    the modules for the block (a forward and its backward, so that
    checkpointed blocks recompute on them too). After the backward,
    :meth:`reduce_gradients` averages the slices' gradients over the data
    group and the replicated ones over every process (each model group's
    members hold copies, which cuDNN's convolution gradients need not make
    equal bit for bit). :meth:`grad_norm` is the norm of the logical arrays
    for the global clip. :meth:`state_dict` and :meth:`load_state_dict` take
    whole tensors under the model's own names; :meth:`optimizer_state` and
    :meth:`load_optimizer_state` do the same for an optimizer's moments."""

    def __init__(self, module: torch.nn.Module, mesh: Mesh):
        if mesh.model < 2:
            raise ValueError("ShardedParameters needs a model axis of 2 or more")
        self.module, self.mesh = module, mesh
        self.placements = param_placements(module, mesh)
        _broadcast_from_rank0(list(module.parameters()) + list(module.buffers()))
        self.slots: List[_Slot] = []
        params = dict(module.named_parameters())
        for name, dim in self.placements.items():
            if dim is None:
                continue
            prefix, _, attr = name.rpartition(".")
            owner = module.get_submodule(prefix)
            p = params[name]
            lo, hi = shard_bounds(p.shape[dim], mesh.model, mesh.model_index)
            slot = _Slot(name, owner, attr, p.shape, dim, lo, hi)
            setattr(owner, attr, torch.nn.Parameter(slot.part(p.detach()).clone(),
                                                    requires_grad=p.requires_grad))
            self.slots.append(slot)
        self.shards = [getattr(s.owner, s.attr) for s in self.slots]
        sharded = {id(p) for p in self.shards}
        self.replicated = [p for p in module.parameters() if id(p) not in sharded]

    @property
    def sharded_numel(self) -> Tuple[int, int]:
        """(elements this process holds of the sharded parameters, their
        whole count)."""
        return sum(p.numel() for p in self.shards), sum(s.numel for s in self.slots)

    @contextlib.contextmanager
    def full(self) -> Iterator[None]:
        """The block runs with the whole tensors in the modules (one
        all-reduce over the model group) and with the mesh current, so that
        BatchNorm's statistics sum over the data group."""
        whole = _Gathered.apply(self, *self.shards)
        for s, t in zip(self.slots, whole):
            s.owner._parameters[s.attr] = t
        try:
            with use_mesh(self.mesh):
                yield
        finally:
            for s, p in zip(self.slots, self.shards):
                s.owner._parameters[s.attr] = p

    def reduce_gradients(self) -> None:
        """Sliced gradients averaged over the data group, replicated ones
        over every process, each in one all-reduce."""
        _mean_in_place([p.grad for p in self.replicated if p.grad is not None], None,
                       process_count())
        _mean_in_place([p.grad for p in self.shards if p.grad is not None],
                       self.mesh.data_group, self.mesh.data)

    def grad_norm(self, params: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of ``params``' gradients as whole arrays: the
        replicated ones' squares plus the slices' squares summed over the
        model group."""
        sharded = {id(p) for p in self.shards}
        norms = {True: [], False: []}
        for p in params:
            if p.grad is not None:
                norms[id(p) in sharded].append(torch.linalg.vector_norm(p.grad))
        device = next(iter(self.module.parameters())).device
        sq = [torch.stack(v).square().sum() if v else torch.zeros((), device=device)
              for v in (norms[False], norms[True])]
        dist.all_reduce(sq[1], group=self.mesh.model_group)
        return (sq[0] + sq[1]).sqrt()

    def gather(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors of slices named by their parameters (the state,
        gradients, moments), on every member of the model group."""
        slots = [s for s in self.slots if s.name in tensors]
        with torch.no_grad():
            whole = _assemble(slots, [tensors[s.name] for s in slots], self.mesh.model_group)
        return {s.name: t.clone() for s, t in zip(slots, whole)}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's state_dict with whole tensors (a collective)."""
        sd = self.module.state_dict()
        sd.update(self.gather({s.name: sd[s.name] for s in self.slots}))
        return sd

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a whole state_dict (strict), each sharded entry's slice."""
        local = dict(sd)
        for s in self.slots:
            if s.name in local and tuple(local[s.name].shape) == s.shape:
                local[s.name] = s.part(local[s.name])
        self.module.load_state_dict(local, strict=True)

    def _trainable(self) -> List[Optional[_Slot]]:
        """The slot of each trainable parameter in module order (None when
        replicated): the indices of an optimizer built on them."""
        by_name = {s.name: s for s in self.slots}
        return [by_name.get(n) for n, p in self.module.named_parameters() if p.requires_grad]

    def optimizer_state(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        """A ``torch.optim`` state_dict over this module's trainable
        parameters with the sliced moments made whole (a collective)."""
        slots = self._trainable()
        keyed = [(i, k) for i, st in sd["state"].items() for k, v in st.items()
                 if slots[i] is not None and torch.is_tensor(v) and v.ndim > 0]
        with torch.no_grad():
            whole = _assemble([slots[i] for i, _ in keyed],
                              [sd["state"][i][k] for i, k in keyed], self.mesh.model_group)
        state = {i: dict(st) for i, st in sd["state"].items()}
        for (i, k), t in zip(keyed, whole):
            state[i][k] = t.clone()
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_optimizer_state(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        """A whole optimizer state_dict cut to this process's slices."""
        slots = self._trainable()
        state = {}
        for i, st in sd["state"].items():
            s = slots[int(i)]
            state[i] = {k: s.part(v).clone() if s is not None and torch.is_tensor(v)
                        and tuple(v.shape) == s.shape else v for k, v in st.items()}
        return {"state": state, "param_groups": sd["param_groups"]}


def _mean_in_place(tensors: List[torch.Tensor], group, n: int) -> None:
    """``tensors`` replaced by their mean over ``group`` of ``n`` processes."""
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def _broadcast_from_rank0(tensors: List[torch.Tensor]) -> None:
    """Every tensor set to rank 0's, one broadcast per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
