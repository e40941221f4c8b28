"""Fused SGD + momentum + weight decay: one hand-written CUDA launch over
every parameter leaf, and its plain twin.

Counterpart of ``tpu_dist/ops/fused_sgd.py`` (the Pallas kernel ``_kernel``
that ``fused_sgd_leaf`` launches once per leaf). Per element, in f32::

    g' = g + wd * p
    b' = mu * b + g'
    p' = p - lr * b'

Unlike the JAX function, which returns new arrays, both versions update
``p`` and ``b`` IN PLACE: at ViT-B/16's 86.6 M parameters that saves two
346 MB copies per step. The kernel (``csrc/fused_sgd.cu``) rounds after
each of the six operations, as :func:`fused_sgd_reference` does, so the
two agree bit for bit.

The launch path. A :class:`Plan` cuts every leaf into tiles of ``TILE``
elements (a leaf's last tile takes its remainder), ``MAX_LEAVES`` leaves at
most a launch, and holds, per launch, the kernel's leaf table as a host
array of int64: first tiles, lengths and the p, g, b pointers. The C
function copies it into the kernel's parameters, so a call copies nothing
to the device, pins nothing and allocates nothing, and can be captured in
a CUDA graph. Plans are cached by the metadata of their leaves (pointer,
shape, dtype, contiguity and device of every p, g and b): a call whose
leaves have not moved reuses its plan, and any change, such as a gradient
reallocated between steps, builds and validates a new one
(``PlanCache.hits`` and ``misses`` count both). ``lr`` is a device scalar
the kernel reads, or a float passed by value.

Leaves are float32 (anything else raises ``TypeError``) and contiguous.
CPU tensors take :func:`fused_sgd_reference`; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import operator
import threading
from typing import List, Sequence, Tuple, Union

import torch

from tpu_dist_torch.ops import _build

# as csrc/fused_sgd.cu is built (its entry point refuses a table planned
# for another tile): elements a tile, and the leaves one launch's parameter
# table holds (40 bytes each, within CUDA's 32,764)
TILE = 4096
MAX_LEAVES = 768
PLANS_KEPT = 8     # leaf sets a cache keeps plans for

ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


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


# -- the plan: pure Python over the leaves' metadata ---------------------------


def split_launches(lengths: Sequence[int], tile: int = TILE,
                   max_leaves: int = MAX_LEAVES) -> List[Tuple[tuple, tuple]]:
    """``[(leaf indices, first tiles)]``, one entry a launch: the non-empty
    leaves in order, ``max_leaves`` at most a launch; ``first[i]`` is the
    launch's first tile of its i-th leaf and ``first[-1]`` its number of
    tiles."""
    leaves = [i for i, n in enumerate(lengths) if n > 0]
    out = []
    for lo in range(0, len(leaves), max_leaves):
        group = tuple(leaves[lo:lo + max_leaves])
        first = [0]
        for i in group:
            first.append(first[-1] + -(-lengths[i] // tile))
        out.append((group, tuple(first)))
    return out


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch: the leaves it updates (indices into the caller's
    lists), their first tiles and lengths, and the table the C function
    reads (``[first | lengths | p | g | b]`` as int64, ``5 * n + 1``)."""

    leaves: tuple
    first: tuple
    lengths: tuple
    table: ctypes.Array

    @property
    def address(self) -> int:
        return ctypes.addressof(self.table)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launches of one leaf set, for leaves on ``device`` (a CUDA
    index, or -1 for the CPU)."""

    device: int
    launches: tuple


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
    if params:
        dev = params[0].device
        if (dev.type not in ("cuda", "cpu")
                or any(t.device != dev for t in (*params, *grads, *bufs))):
            raise ValueError(
                "fused_sgd runs on CUDA (the kernel) or the CPU (its plain version), "
                "with every leaf on one device"
            )


def make_plan(params, grads, bufs, tile: int = TILE, max_leaves: int = MAX_LEAVES) -> Plan:
    """Validate a leaf set fully and cut it into launches (for a kernel
    built with another tile or table size, pass its own)."""
    _check(params, grads, bufs)
    lengths = [p.numel() for p in params]
    launches = []
    for leaves, first in split_launches(lengths, tile, max_leaves):
        values = [*first, *(lengths[i] for i in leaves)]
        for ts in (params, grads, bufs):
            values += [ts[i].data_ptr() for i in leaves]
        launches.append(Launch(leaves, first, tuple(lengths[i] for i in leaves),
                               (ctypes.c_longlong * len(values))(*values)))
    device = params[0].get_device() if params else -1
    return Plan(device, tuple(launches))


_PTR, _CONTIG, _DEVICE = torch.Tensor.data_ptr, torch.Tensor.is_contiguous, torch.Tensor.get_device
_SHAPE, _DTYPE = operator.attrgetter("shape"), operator.attrgetter("dtype")


def leaf_key(params, grads, bufs) -> tuple:
    """What a plan depends on: the pointer, shape, contiguity, dtype and
    device of every p, g and b (and how many of each)."""
    ts = [*params, *grads, *bufs]
    return (len(params), len(grads), len(bufs), *map(_PTR, ts), *map(_SHAPE, ts),
            *map(_CONTIG, ts), *map(_DTYPE, ts), *map(_DEVICE, ts))


class PlanCache:
    """The plans of the last ``size`` leaf sets, by :func:`leaf_key`: a hit
    is a leaf set whose every tensor has the pointer, shape, dtype,
    contiguity and device that were validated, so it reuses its plan; any
    other set (a miss) is validated and planned anew. ``hits`` and
    ``misses`` count the calls of each kind."""

    def __init__(self, size: int = PLANS_KEPT):
        self.size = size
        self.hits = self.misses = 0
        self._plans = {}
        self._lock = threading.Lock()  # for misses; a hit only reads the dict

    def get(self, params, grads, bufs) -> Plan:
        key = leaf_key(params, grads, bufs)
        plan = self._plans.get(key)
        if plan is not None:
            self.hits += 1
        else:
            self.misses += 1
            plan = make_plan(params, grads, bufs)
            with self._lock:
                while len(self._plans) >= self.size:
                    self._plans.pop(next(iter(self._plans)))  # the oldest
                self._plans[key] = plan
        return plan


PLANS = PlanCache()  # the plans fused_sgd launches


# -- the launch ----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, bound once a process."""
    return _build.bind("fused_sgd", "tpu_dist_fused_sgd", ARGTYPES)


def launch(plan: Plan, lr: Union[float, torch.Tensor], momentum: float,
           weight_decay: float) -> None:
    """Launch ``plan`` on its device's current stream; raises on a launch
    error, or on a table the kernel refuses."""
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1 or lr.dtype != torch.float32 or lr.get_device() != plan.device:
            raise TypeError(f"lr must be a float32 scalar on cuda:{plan.device}, got "
                            f"{lr.dtype} {tuple(lr.shape)} on {lr.device}")
        lr_ptr, lr_value = lr.data_ptr(), 0.0
    else:
        lr_ptr, lr_value = None, float(lr)
    fn = _kernel()
    stream = torch._C._cuda_getCurrentRawStream(plan.device)  # the capture stream under a graph
    for one in plan.launches:
        err = fn(one.address, len(one.leaves), lr_ptr, lr_value, momentum, weight_decay,
                 plan.device, stream)
        if err != 0:
            raise RuntimeError(f"fused_sgd kernel launch failed: CUDA error {err}")
        fused_sgd.launches += 1


def fused_sgd(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              bufs: Sequence[torch.Tensor], lr: Union[float, torch.Tensor], *,
              momentum: float = 0.9, weight_decay: float = 1e-4) -> None:
    """Update every ``(p, b)`` in place from its gradient ``g``. ``lr`` is a
    float or a float32 scalar tensor on the leaves' device (a tensor, for a
    CUDA graph whose learning rate changes between replays).

    On CUDA: one kernel launch over all leaves, up to ``MAX_LEAVES``
    (``fused_sgd.launches`` counts them). On the CPU:
    :func:`fused_sgd_reference`."""
    if params and params[0].is_cuda:
        launch(PLANS.get(params, grads, bufs), lr, momentum, weight_decay)
        return
    _check(params, grads, bufs)
    if params:
        fused_sgd_reference(params, grads, bufs, lr, momentum=momentum,
                            weight_decay=weight_decay)


fused_sgd.launches = 0
