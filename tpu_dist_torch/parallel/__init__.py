"""Model parallelism: the port's counterpart of ``tpu_dist/parallel/``
(tensor, expert and pipeline parallelism; FSDP waits for ROADMAP Queue A
3)."""

from tpu_dist_torch.parallel.tensor import (  # noqa: F401
    column_parallel_dense,
    lockstep_row_parallel_dense,
    row_parallel_dense,
    shard,
    shard_columns,
    shard_rows,
)
from tpu_dist_torch.parallel.expert import MoE  # noqa: F401
