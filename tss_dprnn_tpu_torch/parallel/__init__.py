"""Data and model parallelism over ``torch.distributed`` (counterpart of
``tss_dprnn_tpu/parallel/``).

One process per card. Without a mesh, or with ``make_mesh(data, 1)``, the
process group's world size plays the part of the JAX mesh's ``data`` axis:
training wraps the model in ``DistributedDataParallel`` (its broadcast at
construction replicates the weights, its gradient all-reduce is the data
axis's mean), BatchNorm takes the global batch's statistics, each loader
gives its process the rows that JAX's ``shard_batch`` would put on it, and
evaluation runs whole batches per process.

``make_mesh(data, model)`` with ``model`` > 1 adds the ``model`` axis: a
``Trainer`` or ``Inferencer`` given the mesh keeps, on each process, its
slice of the parameters that ``DEFAULT_TP_RULES`` match
(``ShardedParameters``; Adam's moments follow), gathers them whole over the
model group before the model runs, and reduces the data axis over the data
group (the processes of one model index).
"""

from tss_dprnn_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_count,
    host_group,
    initialize_distributed,
    is_distributed,
    join_group,
    leave_group,
    local_rank,
    make_mesh,
    process_count,
    process_index,
)
from tss_dprnn_tpu_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_TP_RULES,
    ShardedParameters,
    barrier,
    differentiable_sum,
    gather_objects,
    longest_over_processes,
    mean_over_processes,
    param_placements,
    shard_bounds,
    sum_numbers_over_processes,
)
