"""Fused SGD + momentum + weight decay: one hand-written CUDA launch over
every parameter leaf, and its plain twin.

Counterpart of ``tpu_dist/ops/fused_sgd.py`` (the Pallas kernel ``_kernel``
that ``fused_sgd_leaf`` launches once per leaf). Per element, in f32::

    g' = g + wd * p
    b' = mu * b + g'
    p' = p - lr * b'

Unlike the JAX function, which returns new arrays, both versions update
``p`` and ``b`` IN PLACE: at ViT-B/16's 86.6 M parameters that saves two
346 MB copies per step. The kernel (``csrc/fused_sgd.cu``) takes all
leaves in one launch from a device table of their pointers, rebuilt every
call from a pinned host buffer (a ``.grad`` reallocated between steps can
never leave a stale pointer behind), and reads ``lr`` from a device
scalar. It rounds after each of the six operations, as
:func:`fused_sgd_reference` does, so the two agree bit for bit.

Leaves are float32 (anything else raises ``TypeError``) and contiguous.
CPU tensors take :func:`fused_sgd_reference`; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Union

import torch

from tpu_dist_torch.ops import _build

CHUNK = 1 << 16  # elements per CTA, as csrc/fused_sgd.cu has it
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def fused_sgd_reference(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                        bufs: Sequence[torch.Tensor], lr, *, momentum: float = 0.9,
                        weight_decay: float = 1e-4) -> None:
    """The plain version of :func:`fused_sgd`: the six operations one at a
    time per leaf, each rounded to f32, ``p`` and ``b`` updated in place."""
    with torch.no_grad():
        for p, g, b in zip(params, grads, bufs):
            g2 = g + p * weight_decay
            b.copy_(b * momentum + g2)
            p.copy_(p - b * lr)


def chunk_table(params, grads, bufs):
    """The kernel's table as a list of int64 (``[p pointers | g pointers |
    b pointers | lengths | first chunks]``, leaf order) and the number of
    chunks, one CTA each."""
    lengths = [p.numel() for p in params]
    first, n_chunks = [], 0
    for n in lengths:
        first.append(n_chunks)
        n_chunks += math.ceil(n / CHUNK)
    table = ([p.data_ptr() for p in params] + [g.data_ptr() for g in grads]
             + [b.data_ptr() for b in bufs] + lengths + first)
    return table, n_chunks


def _check(params, grads, bufs) -> None:
    if not (len(params) == len(grads) == len(bufs)):
        raise ValueError(
            f"fused_sgd takes one grad and one buffer per parameter, got "
            f"{len(params)}, {len(grads)}, {len(bufs)}"
        )
    for i, (p, g, b) in enumerate(zip(params, grads, bufs)):
        if not (p.dtype == g.dtype == b.dtype == torch.float32):
            raise TypeError(
                f"fused_sgd takes float32 leaves; leaf {i} has p {p.dtype}, "
                f"g {g.dtype}, b {b.dtype}"
            )
        if not (p.shape == g.shape == b.shape):
            raise ValueError(
                f"leaf {i}: p {tuple(p.shape)}, g {tuple(g.shape)}, b {tuple(b.shape)}"
            )
        if not (p.is_contiguous() and g.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"leaf {i}: fused_sgd takes contiguous p, g, b")


def fused_sgd(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              bufs: Sequence[torch.Tensor], lr: Union[float, torch.Tensor], *,
              momentum: float = 0.9, weight_decay: float = 1e-4) -> None:
    """Update every ``(p, b)`` in place from its gradient ``g``. ``lr`` is a
    float or a float32 scalar tensor on the leaves' device.

    On CUDA: one kernel launch over all leaves (``fused_sgd.launches``
    counts them). On the CPU: :func:`fused_sgd_reference`."""
    _check(params, grads, bufs)
    if not params:
        return
    dev = params[0].device
    if any(t.device != dev for t in (*params, *grads, *bufs)) or dev.type not in ("cuda", "cpu"):
        raise ValueError(
            "fused_sgd runs on CUDA (the kernel) or the CPU (its plain version), "
            "with every leaf on one device"
        )
    if dev.type == "cpu":
        fused_sgd_reference(params, grads, bufs, lr, momentum=momentum,
                            weight_decay=weight_decay)
        return
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1 or lr.dtype != torch.float32 or lr.device != dev:
            raise TypeError(f"lr must be a float32 scalar on {dev}, got {lr.dtype} on {lr.device}")
        lr_t = lr
    else:
        lr_t = torch.full((), float(lr), dtype=torch.float32, device=dev)
    table, n_chunks = chunk_table(params, grads, bufs)
    # pinned and non-blocking: the host allocator keeps the buffer until the
    # copy has run, and the host never waits for the step's earlier work
    table_t = torch.tensor(table, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    fn = _build.bind("fused_sgd", "tpu_dist_fused_sgd", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(table_t.data_ptr(), len(params), n_chunks, lr_t.data_ptr(),
                 float(momentum), float(weight_decay),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_sgd kernel launch failed: CUDA error {err}")
    fused_sgd.launches += 1


fused_sgd.launches = 0
