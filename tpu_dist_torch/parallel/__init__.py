"""Model parallelism: the port's counterpart of ``tpu_dist/parallel/``
(tensor, expert and pipeline parallelism, and FSDP)."""

from tpu_dist_torch.parallel.tensor import (  # noqa: F401
    column_parallel_dense,
    lockstep_row_parallel_dense,
    row_parallel_dense,
    shard,
    shard_columns,
    shard_rows,
)
from tpu_dist_torch.parallel.expert import MoE  # noqa: F401
from tpu_dist_torch.parallel.fsdp import (  # noqa: F401
    FSDPShards,
    compose_fsdp_specs,
    fsdp_dims,
    fsdp_specs,
    make_fsdp_eval_step,
    make_fsdp_train_step,
    shard_state,
)
