"""Data parallelism over ``torch.distributed`` (counterpart of the data axis
of ``tss_dprnn_tpu/parallel/``).

One process per card; the process group's world size plays the part of the
JAX mesh's ``data`` axis. Training wraps the model in
``DistributedDataParallel`` (its broadcast at construction replicates the
weights, its gradient all-reduce is the data axis's mean) and BatchNorm
takes the global batch's statistics; each loader gives its process the rows
that JAX's ``shard_batch`` would put on it; evaluation runs whole batches
per process. The mesh's ``model`` axis (tensor parallelism) is not ported.
"""

from tss_dprnn_tpu_torch.parallel.mesh import (  # noqa: F401
    host_group,
    initialize_distributed,
    is_distributed,
    join_group,
    leave_group,
    local_rank,
    process_count,
    process_index,
)
from tss_dprnn_tpu_torch.parallel.sharding import (  # noqa: F401
    barrier,
    differentiable_sum,
    gather_objects,
    longest_over_processes,
    mean_over_processes,
    sum_numbers_over_processes,
)
