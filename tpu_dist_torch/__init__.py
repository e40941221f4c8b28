"""PyTorch/CUDA port of ``tpu_dist`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one: it imports ``torch`` and never
``jax`` or anything of ``tpu_dist``. Module names mirror ``tpu_dist`` so
each counterpart is easy to find. Every Pallas TPU kernel on a ported
path becomes a hand-written CUDA kernel under ``csrc/``, with its plain
PyTorch twin in the same module.

Entry points run on CUDA by default. ``device="cpu"`` runs them on the
CPU (the kernels' plain versions); with no GPU and no ``device="cpu"``
they raise rather than move to the CPU quietly.

Importing the package loads no torch: the stdlib-only modules (the
heartbeat, the flight ring, the fault plan) start in a few milliseconds,
for a process that only beats or reads beats.
"""

from __future__ import annotations


def resolve_device(device="cuda") -> "torch.device":  # noqa: F821
    """``device`` as a :class:`torch.device`. A CUDA device with no GPU
    present raises: the caller must ask for the CPU explicitly."""
    import torch  # noqa: PLC0415 — the package itself imports no torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
