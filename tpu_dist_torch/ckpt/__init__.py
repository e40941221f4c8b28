"""Checkpoint / resume in the JAX package's plain ``.npz`` format (the port
of ``tpu_dist/ckpt``; the sharded format is not ported). The typed
mismatch errors and the ``elastic`` stamp are ``tpu_dist_torch.elastic``'s,
re-exported here."""

from tpu_dist_torch.ckpt.checkpoint import (
    CKPT_READ_ERRORS,
    AsyncCheckpointer,
    CheckpointCorruptError,
    all_checkpoints,
    latest_checkpoint,
    quarantine,
    read_meta,
    restore,
    save,
    save_best,
    set_io_retries,
    sweep_stale_tmp,
    verify_npz,
)
from tpu_dist_torch.elastic import (
    ConfigMismatchError,
    ElasticShapeMismatch,
    elastic_stamp,
    params_len,
)

__all__ = [
    "CKPT_READ_ERRORS",
    "AsyncCheckpointer",
    "CheckpointCorruptError",
    "ConfigMismatchError",
    "ElasticShapeMismatch",
    "all_checkpoints",
    "elastic_stamp",
    "latest_checkpoint",
    "params_len",
    "quarantine",
    "read_meta",
    "restore",
    "save",
    "save_best",
    "set_io_retries",
    "sweep_stale_tmp",
    "verify_npz",
]
