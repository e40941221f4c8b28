"""Pipeline parallelism over a pipe group: the port's counterpart of
``tpu_dist/parallel/pipeline.py`` (``pipeline_apply``, ``bubble_fraction``,
``pipeline_apply_interleaved``).

Every rank of a pipe group holds one stage; microbatches flow through the
stages tick by tick. One schedule (:func:`schedule`) serves GPipe (one
chunk a stage) and Megatron's interleaved virtual stages (``v`` chunks a
stage, a microbatch lapping the ring ``v`` times): stage ``d`` is busy
ticks ``[d, d + vM)`` and at relative tick ``r = t - d`` runs chunk ``k =
r // M`` on microbatch ``m = r % M``. Its input is microbatch ``m`` (the
first virtual stage), the previous stage's output of the tick before, or,
for stage 0 past its first lap, the last stage's output from ``M - S``
ticks before (the lap boundary), held in a buffer of depth ``Q = M - S +
1``; its output goes to the next stage, around the ring to stage 0 at a
lap boundary, or into the result (the last virtual stage).

Two runners walk it:

* :func:`pipeline_apply` and :func:`pipeline_apply_interleaved`: one rank a
  stage, the handoff a ``batch_isend_irecv`` a tick
  (:func:`~tpu_dist_torch.comm.collectives.stage_handoff`), the
  microbatches fed through ``copy_to_pipe`` and the last stage's outputs
  returned to every rank through ``reduce_from_pipe``, as the JAX
  functions do. Differentiable with JAX's convention: each rank
  differentiates its own replica of the loss.
* :func:`pipeline_lockstep`: every stage in one process (one card holds no
  NCCL group), the handoff a hand-over of tensors.

The JAX functions run every device's stage on every tick and throw the
bubble's results away (zeros in, or ``jnp.where(active, y, h)``), and the
GPipe ring sends around the wrap (n-1 -> 0) on every tick. Here a stage
runs on its active ticks only, and the wrap is sent only at a lap
boundary: the same numbers, with no bubble work.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch

from tpu_dist_torch.comm import collectives
from tpu_dist_torch.obs import costmodel


def bubble_fraction(n_stages: int, n_micro: int, interleave: int = 1) -> float:
    """Idle fraction of the pipeline's tick accounting: ``(S-1)/(M+S-1)``
    for GPipe, ``(S-1)/(vM+S-1)`` with ``v`` interleaved chunks a stage."""
    s, m, v = n_stages, n_micro, interleave
    return (s - 1) / (v * m + s - 1)


@dataclasses.dataclass(frozen=True)
class Slot:
    """What one stage does at one tick: chunk ``k`` on microbatch ``m``,
    its input from ``src`` (``"feed"``: microbatch ``m``; ``"prev"``: the
    previous stage's output of the tick before; ``"wrap"``: the lap
    boundary's buffer) and its output to ``dst`` (``"next"``, ``"wrap"``
    or ``"out"``)."""

    k: int
    m: int
    src: str
    dst: str


def schedule(n_stages: int, n_micro: int, interleave: int = 1) -> list:
    """``[tick][stage]`` -> :class:`Slot`, or None on a bubble tick, over
    ``interleave · n_micro + n_stages - 1`` ticks. The interleaved schedule
    (``interleave > 1``) needs ``n_micro >= n_stages``, as in JAX."""
    n, M, v = int(n_stages), int(n_micro), int(interleave)
    if v > 1 and M < n:
        raise ValueError(
            f"interleaved schedule requires n_microbatches >= n_stages "
            f"(a microbatch laps the ring {v}x; fewer than S in flight "
            f"starves the warmup ramp); got M={M}, S={n}"
        )
    ticks = []
    for t in range(v * M + n - 1):
        row = []
        for d in range(n):
            r = t - d
            if not 0 <= r < v * M:
                row.append(None)
                continue
            k, m = divmod(r, M)
            src = "feed" if d == 0 and k == 0 else "wrap" if d == 0 else "prev"
            dst = "out" if d == n - 1 and k == v - 1 else "wrap" if d == n - 1 else "next"
            row.append(Slot(k, m, src, dst))
        ticks.append(row)
    return ticks


class _LapBuffer:
    """The lap-boundary buffer of stage 0: arrivals in tick order, each read
    ``M - S`` ticks after it lands; never more than ``Q = M - S + 1`` held."""

    def __init__(self, depth: int):
        self.depth = depth
        self.held = collections.deque()

    def push(self, h) -> None:
        self.held.append(h)
        if len(self.held) > self.depth:
            raise RuntimeError(f"lap-boundary buffer over its depth {self.depth}")

    def pop(self):
        return self.held.popleft()


def pipeline_lockstep(chunk_fns: list, x_micro: torch.Tensor, interleave: int = 1) -> torch.Tensor:
    """The schedule with every stage in this process: ``chunk_fns[d](k, h)``
    runs stage ``d``'s chunk ``k``; ``x_micro`` is ``[M, B_micro, ...]``.
    Each tick runs the active stages, then hands each output on. Returns
    the last virtual stage's outputs, ``[M, B_micro, ...]``."""
    n, M = len(chunk_fns), x_micro.shape[0]
    inbox = [None] * n
    lap = _LapBuffer(M - n + 1)
    outs = [None] * M
    for row in schedule(n, M, interleave):
        done = []
        for d, slot in enumerate(row):
            if slot is None:
                continue
            h = (x_micro[slot.m] if slot.src == "feed" else lap.pop() if slot.src == "wrap"
                 else inbox[d])
            done.append((d, slot, chunk_fns[d](slot.k, h)))
        for d, slot, y in done:
            if slot.dst == "out":
                outs[slot.m] = y
            elif slot.dst == "wrap":
                lap.push(y)
            else:
                inbox[d + 1] = y
    return torch.stack(outs)


class _Anchor(torch.autograd.Function):
    """The first ticket of a rank's tick chain, a 0-dim zero hung on the
    microbatches (and the stage's parameters): the backward of every
    handoff then leads to tensors whose gradients the caller takes, so a
    backward that prunes its graph to them still runs every exchange, and
    ``copy_to_pipe``'s all-reduce runs on every rank, after them. Marks the
    start of the stage's work for the cost count, and its end in the
    backward."""

    @staticmethod
    def forward(ctx, *tensors):
        ctx.likes = [(t.shape, t.dtype, t.device) for t in tensors]
        costmodel.stage_region(True)
        return torch.zeros((), dtype=torch.float32, device=tensors[0].device)

    @staticmethod
    def backward(ctx, g):
        costmodel.stage_region(False)
        return tuple(torch.zeros(s, dtype=dt, device=dev) for s, dt, dev in ctx.likes)


class _Attach(torch.autograd.Function):
    """``x`` as it is, with the last ticket of the chain hung on it, so
    every rank's loss reaches its chain; marks the end of the stage's work
    for the cost count, and its start in the backward."""

    @staticmethod
    def forward(ctx, x, ticket):
        costmodel.stage_region(False)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        costmodel.stage_region(True)
        return g, torch.zeros((), dtype=torch.float32, device=g.device)


def pipeline_apply_interleaved(chunk_fn: Callable, x_micro: torch.Tensor, pipe,
                               interleave: int, *, params=()) -> torch.Tensor:
    """Run microbatches through the interleaved schedule over the pipe group
    ``pipe`` (an :class:`~tpu_dist_torch.comm.mesh.AxisGroup`, this rank
    stage ``pipe.index``): ``chunk_fn(k, h)`` runs this rank's chunk ``k``
    (virtual stage ``k·S + index``); ``x_micro`` is ``[M, B_micro, ...]``,
    the same on every rank. Returns the last virtual stage's outputs on
    every rank. ``params`` are the stage's parameters, needed only when
    ``x_micro`` takes no gradient (:class:`_Anchor`). A group of one runs
    :func:`pipeline_lockstep`."""
    n, d = pipe.size, pipe.index
    if n == 1:
        return pipeline_lockstep([chunk_fn], x_micro, interleave)
    if not collectives.active():
        raise ValueError(f"a pipe group of {n} stages needs a process group; run the stages "
                         "of one process through pipeline_lockstep")
    group = pipe.group
    nxt = collectives.global_rank(group, (d + 1) % n)
    prv = collectives.global_rank(group, (d - 1) % n)
    x_micro = collectives.copy_to_pipe(x_micro, group=group)
    M = x_micro.shape[0]
    ticket = _Anchor.apply(x_micro, *params)
    lap = _LapBuffer(M - n + 1)
    h, outs = None, [None] * M
    for row in schedule(n, M, interleave):
        slot, before = row[d], row[(d - 1) % n]
        y = None
        if slot is not None:
            inp = (x_micro[slot.m] if slot.src == "feed" else lap.pop() if slot.src == "wrap"
                   else h)
            y = chunk_fn(slot.k, inp)
            if slot.dst == "out":
                outs[slot.m] = y
        send = slot is not None and slot.dst != "out"
        recv = before is not None and before.dst != "out"
        ticket, got = collectives.stage_handoff(
            ticket, y if send else None, x_micro[0], group=group,
            nxt=nxt if send else None, prv=prv if recv else None)
        if recv:
            if d == 0:
                lap.push(got)
            else:
                h = got
    last = torch.stack(outs) if d == n - 1 else torch.zeros_like(x_micro)
    return collectives.reduce_from_pipe(_Attach.apply(last, ticket), group=group)


def pipeline_apply(stage_fn: Callable, x_micro: torch.Tensor, pipe, *,
                   params=()) -> torch.Tensor:
    """GPipe over the pipe group ``pipe``: ``stage_fn(h)`` runs this rank's
    stage (:func:`pipeline_apply_interleaved` with one chunk a stage)."""
    return pipeline_apply_interleaved(lambda k, h: stage_fn(h), x_micro, pipe, 1,
                                      params=params)

