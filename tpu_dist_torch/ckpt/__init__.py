"""Checkpoint / resume in the JAX package's plain ``.npz`` format (the port
of ``tpu_dist/ckpt``; the sharded format is not ported)."""

from tpu_dist_torch.ckpt.checkpoint import (
    CKPT_READ_ERRORS,
    AsyncCheckpointer,
    CheckpointCorruptError,
    ConfigMismatchError,
    all_checkpoints,
    elastic_stamp,
    latest_checkpoint,
    params_len,
    quarantine,
    read_meta,
    restore,
    save,
    save_best,
    set_io_retries,
    sweep_stale_tmp,
    verify_npz,
)

__all__ = [
    "CKPT_READ_ERRORS",
    "AsyncCheckpointer",
    "CheckpointCorruptError",
    "ConfigMismatchError",
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
