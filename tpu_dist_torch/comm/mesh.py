"""Process group bring-up and rank queries: the port's counterpart of
``tpu_dist/comm/mesh.py`` (``initialize_distributed``, ``process_index``,
``process_count``, ``local_device_count``, ``is_primary``).

The JAX package runs one process per host driving every local chip over a
device mesh; the port runs one process per card, as the reference's
``torch.distributed`` scripts do, and joins them into one
``torch.distributed`` process group: NCCL for CUDA devices, gloo for the
CPU. The rendezvous reads ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
``MASTER_ADDR``/``MASTER_PORT`` as ``torchrun`` sets them, falling back to
the caller's values. A world of one process still builds a real group, so
the card runs real NCCL collectives.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from tpu_dist_torch import resolve_device


def _env_int(name: str, fallback: Optional[int]) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else fallback


def backend_for(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    device="cuda",
    *,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    master_addr: str = "127.0.0.1",
    master_port: int = 23456,
) -> tuple:
    """Join the default process group; returns ``(rank device, created)``.

    ``created`` is False when a group already exists (it is then reused as
    it is, and its owner destroys it). Environment variables set by
    ``torchrun`` or a spawning launcher win over the arguments. For CUDA
    the process takes card ``LOCAL_RANK`` (else its rank) of the visible
    ones; for the CPU every rank shares the host."""
    dev = resolve_device(device)
    rank = _env_int("RANK", rank if rank is not None else 0)
    world_size = _env_int("WORLD_SIZE", world_size if world_size is not None else 1)
    local_rank = _env_int("LOCAL_RANK", rank)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for a world of {world_size}")
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else local_rank
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} wants card {index} but {torch.cuda.device_count()} are visible"
            )
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev, False
    addr = os.environ.get("MASTER_ADDR") or master_addr
    port = _env_int("MASTER_PORT", master_port)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(
        backend_for(dev), init_method=f"tcp://{addr}:{port}",
        world_size=world_size, rank=rank, **kw,
    )
    return dev, True


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The world size (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_device_count(device="cuda") -> int:
    """Cards of ``device``'s type visible on this host (one process each);
    1 for the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def is_primary() -> bool:
    """True on the process allowed to print (rank-0 discipline)."""
    return process_index() == 0
