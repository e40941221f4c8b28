"""PyTorch/CUDA port of ``tpu_dist`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one: it imports ``torch`` and never
``jax`` or anything of ``tpu_dist``. Module names mirror ``tpu_dist`` so
each counterpart is easy to find. Every Pallas TPU kernel on a ported
path becomes a hand-written CUDA kernel under ``csrc/``, with its plain
PyTorch twin in the same module.

Entry points run on CUDA by default. ``device="cpu"`` runs them on the
CPU (the kernels' plain versions); with no GPU and no ``device="cpu"``
they raise rather than move to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`. A CUDA device with no GPU
    present raises: the caller must ask for the CPU explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
