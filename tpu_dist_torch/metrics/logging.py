"""Rank-0 logging discipline: the port's counterpart of
``tpu_dist/metrics/logging.py``. Only rank 0 of the process group prints
(every process prints without a group)."""

from __future__ import annotations

from tpu_dist_torch.comm import mesh


def rank0_print(*args, **kwargs) -> None:
    if mesh.is_primary():
        print(*args, **kwargs, flush=True)
