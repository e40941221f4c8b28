"""Collectives over the default process group: the port's counterpart of
``tpu_dist/comm/collectives.py`` (``reduce_mean``, ``reduce_sum``,
``all_gather``, ``broadcast_from``, ``barrier``, ``host_allreduce_mean``).

The JAX functions are traced ``lax`` collectives inside a ``shard_map``;
these are eager ``torch.distributed`` calls (NCCL on the card, gloo on the
CPU) on tensors of this rank. Each all-reduce goes through
:func:`all_reduce_`, which adds one to the counter ``comm.all_reduce.<kind>``
(``tpu_dist_torch.obs.counters``) per call, so a caller can show how many
collectives of each kind a step issued: ``grad`` (the DDP gradient
reduce), ``bn`` (SyncBN statistics), ``bn_state``, ``metrics``, ``eval``.
The flat collectives of ZeRO-1 and the int8 gradient wire count the same
way: :func:`reduce_scatter` under ``comm.reduce_scatter.<kind>``,
:func:`all_to_all` under ``comm.all_to_all.<kind>`` and
:func:`all_gather_flat` under ``comm.all_gather.<kind>`` (and
:func:`gather_flat`, the checkpoint writer's, under ``comm.gather.<kind>``),
one a call. They run over the group even at a world of one (where they
are copies).

Sequence parallelism adds two differentiable exchanges over a seq group:
:func:`ring_rotate` (``lax.ppermute`` with the perm ``i -> i+1``: one
``batch_isend_irecv`` to the next rank and from the previous one, counted
under ``comm.ppermute.<kind>``; its backward rotates the cotangent the
other way) and :func:`all_to_all_tiled` (``lax.all_to_all(...,
tiled=True)`` along any two axes, counted under ``comm.all_to_all.<kind>``;
its backward is the inverse exchange).

Pipeline parallelism adds the stage handoff over a pipe group,
:func:`stage_handoff` (one ``batch_isend_irecv`` a tick: the output to the
next stage, the previous stage's received; counted ``comm.ppermute.pipe``
and ``pipe_grad``), and the conjugate pair under the kind ``pipe``:
:func:`copy_to_pipe` and :func:`reduce_from_pipe` (``comm.all_reduce.pipe``
and ``pipe_grad``).

Tensor parallelism adds the Megatron conjugate pair over a model group,
:func:`copy_to_tp` (identity forward, all-reduce backward, counted
``comm.all_reduce.tp_grad``) and :func:`reduce_from_tp` (all-reduce
forward, counted ``comm.all_reduce.tp``, identity backward). The MoE's slot
exchange over an expert group is :func:`all_to_all_tiled` along dim 0 of
the ``[n, e_loc, C, d]`` blocks (``lax.all_to_all(..., tiled=False)``),
counted ``comm.all_to_all.moe`` and ``moe_grad``.

FSDP adds the gather of a leaf's shards along one dimension before use,
:func:`all_gather_dim` (``comm.all_gather.fsdp_params``), and the
reduce-scatter of its gradient into the shards, :func:`reduce_scatter_dim`
(``comm.reduce_scatter.fsdp_grad``), with their lockstep forms for a group
of virtual ranks in one process (:func:`lockstep_all_gather_dim`,
:func:`lockstep_reduce_scatter_dim`), counted as the collectives they
stand for.

Without an initialised process group every function is the identity of a
world of one process and counts nothing (the lockstep forms count).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_dist_torch.obs import counters

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def active() -> bool:
    """Whether a process group exists (else every collective is the
    identity of a world of one)."""
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if active() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if active() else 0


def global_rank(group, index: int) -> int:
    """The default group's rank of member ``index`` of ``group`` (None: the
    default group itself)."""
    if group is None or not active():
        return index
    return dist.get_global_rank(group, index)


def all_reduce_(x: torch.Tensor, op: str = "sum", *, group=None,
                kind: str = "other") -> torch.Tensor:
    """In-place all-reduce of ``x`` (``op`` in sum/max/min); counted under
    ``comm.all_reduce.<kind>``. Returns ``x``."""
    if active():
        counters.inc(f"comm.all_reduce.{kind}")
        dist.all_reduce(x, op=_OPS[op], group=group)
    return x


# the newer names first; older torch has only the *_tensor spellings
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def reduce_scatter(x: torch.Tensor, *, group=None, kind: str = "other",
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum-reduce-scatter of a flat tensor whose length divides by the
    world size ``n``: rank ``r`` gets the sum over the ranks of
    ``x[r*m:(r+1)*m]``, ``m = len(x)/n`` (``lax.psum_scatter(...,
    tiled=True)``), in ``out`` when given. Counted under
    ``comm.reduce_scatter.<kind>``."""
    n = world_size(group)
    if x.numel() % n:
        raise ValueError(f"reduce_scatter of {x.numel()} elements over {n} ranks")
    if out is None:
        out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
    if not active():
        return out.copy_(x.reshape(-1))
    counters.inc(f"comm.reduce_scatter.{kind}")
    _REDUCE_SCATTER(out, x.reshape(-1).contiguous(), group=group)
    return out


def all_to_all(x: torch.Tensor, *, group=None, kind: str = "other") -> torch.Tensor:
    """``x`` of ``n`` equal rows along dim 0 (``n`` the world size): row
    ``j`` goes to rank ``j``, and row ``i`` of the result came from rank
    ``i`` (``lax.all_to_all(..., split_axis=0, concat_axis=0,
    tiled=True)``). Counted under ``comm.all_to_all.<kind>``."""
    n = world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all of {x.shape[0]} rows over {n} ranks")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if not active():
        return out.copy_(x)
    counters.inc(f"comm.all_to_all.{kind}")
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def all_gather_flat(x: torch.Tensor, *, group=None, kind: str = "other") -> torch.Tensor:
    """Every rank's flat ``x`` concatenated in rank order, ``(n·len(x),)``
    (``lax.all_gather(..., tiled=True)``). Counted under
    ``comm.all_gather.<kind>``."""
    out = torch.empty(world_size(group) * x.numel(), dtype=x.dtype, device=x.device)
    if not active():
        return out.copy_(x.reshape(-1))
    counters.inc(f"comm.all_gather.{kind}")
    _ALL_GATHER(out, x.reshape(-1).contiguous(), group=group)
    return out


def gather_flat(x: torch.Tensor, dst: int = 0, *, group=None,
                kind: str = "other") -> Optional[torch.Tensor]:
    """:func:`all_gather_flat` received by rank ``dst`` alone: every rank's
    flat ``x`` concatenated in rank order there, None on the other ranks.
    Counted under ``comm.gather.<kind>``."""
    x = x.reshape(-1).contiguous()
    if not active():
        return x.clone()
    counters.inc(f"comm.gather.{kind}")
    if rank(group) != dst:
        dist.gather(x, dst=dst, group=group)
        return None
    out = torch.empty(world_size(group) * x.numel(), dtype=x.dtype, device=x.device)
    dist.gather(x, gather_list=list(out.chunk(world_size(group))), dst=dst, group=group)
    return out


def _dim_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` moved to the front, contiguous: its blocks along
    ``dim`` are then contiguous runs of the flat buffer."""
    return x.movedim(dim, 0).contiguous()


def all_gather_dim(x: torch.Tensor, dim: int, *, group=None, kind: str = "other") -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order, by one
    all-gather of the flat buffer: FSDP's gather of a leaf's shards before
    use (``comm.all_gather.<kind>``, ``fsdp_params``). A contiguous tensor
    of the full shape."""
    n = world_size(group)
    flat = all_gather_flat(_dim_first(x, dim), group=group, kind=kind)
    lead = x.movedim(dim, 0).shape
    return flat.view(n * lead[0], *lead[1:]).movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, *, group=None, kind: str = "other",
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum over the ranks of ``x``, this rank's block along ``dim`` (its
    size over the world size ``n`` must divide): FSDP's reduce-scatter of a
    leaf's gradient into its shards (``comm.reduce_scatter.<kind>``,
    ``fsdp_grad``). In ``out`` when given, else a new contiguous tensor."""
    n = world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter of {x.shape[dim]} along dim {dim} over {n} ranks")
    lead = x.movedim(dim, 0).shape
    part = reduce_scatter(_dim_first(x, dim), group=group, kind=kind)
    part = part.view(lead[0] // n, *lead[1:]).movedim(0, dim)
    return part.contiguous() if out is None else out.copy_(part)


def lockstep_all_gather_dim(shards: list, dim: int, *, kind: str = "other") -> torch.Tensor:
    """:func:`all_gather_dim` of a lockstep group, whose ranks are virtual
    ranks of one process: ``shards[r]`` is rank ``r``'s, and their join
    along ``dim`` is what the all-gather would give every rank. Counted
    once, as the collective it stands for."""
    counters.inc(f"comm.all_gather.{kind}")
    return torch.cat(list(shards), dim=dim)


def lockstep_reduce_scatter_dim(parts: list, dim: int, n: int, *,
                                kind: str = "other") -> list:
    """:func:`reduce_scatter_dim` of a lockstep group of ``n`` virtual ranks:
    the sum of ``parts`` (the contributions this process holds, summed in
    order) cut into ``n`` blocks along ``dim``, block ``r`` rank ``r``'s
    shard (contiguous copies). Counted once."""
    counters.inc(f"comm.reduce_scatter.{kind}")
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    if total.shape[dim] % n:
        raise ValueError(f"reduce_scatter of {total.shape[dim]} along dim {dim} over {n} ranks")
    return [b.contiguous() for b in total.chunk(n, dim=dim)]


class _SumAcrossRanks(torch.autograd.Function):
    """All-reduce sum whose backward is the all-reduce sum of the
    cotangent: JAX's transpose of ``psum`` (and so, with the 1/n, of
    ``pmean``) inside a ``shard_map``. Each rank's backward thus carries
    the other ranks' terms through the shared statistic."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group=group, kind=kind)

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        return all_reduce_(out, group=ctx.group, kind=ctx.kind + "_grad"), None, None


def sum_across_ranks(x: torch.Tensor, *, group=None, kind: str = "other") -> torch.Tensor:
    """Differentiable cross-rank sum (counted as ``kind`` forward and
    ``<kind>_grad`` backward); the identity without a process group."""
    return _SumAcrossRanks.apply(x, group, kind) if active() else x


def reduce_sum(x: torch.Tensor, *, group=None, kind: str = "other") -> torch.Tensor:
    """Cross-rank sum (``dist.all_reduce(op=SUM)``) into a new tensor."""
    return all_reduce_(x.clone(), group=group, kind=kind)


def reduce_mean(x: torch.Tensor, *, group=None, kind: str = "other") -> torch.Tensor:
    """Cross-rank mean: clone, all-reduce the sum, divide by the world size
    (the reference's ``reduce_mean``, ``utils/util.py:5-9``)."""
    return reduce_sum(x, group=group, kind=kind) / world_size(group)


def all_gather(x: torch.Tensor, *, group=None, axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order (the
    JAX function's ``tiled=True``)."""
    if not active():
        return x.clone()
    parts = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


def gather(x: torch.Tensor, dst: int = 0, *, group=None, axis: int = 0) -> Optional[torch.Tensor]:
    """:func:`all_gather` received by rank ``dst`` alone (a rank of the
    default group, and a member of ``group``): every member's ``x`` joined
    along ``axis`` in rank order there, None on the other members."""
    if not active():
        return x.clone()
    x = x.contiguous()
    if rank() != dst:
        dist.gather(x, dst=dst, group=group)
        return None
    parts = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.gather(x, gather_list=parts, dst=dst, group=group)
    return torch.cat(parts, dim=axis)


def broadcast_from(x: torch.Tensor, src: int = 0, *, group=None) -> torch.Tensor:
    """``src``'s value on every rank, in place in ``x`` (returned): the DDP
    init-time parameter broadcast."""
    if active():
        dist.broadcast(x, src=src, group=group)
    return x


def barrier(group=None) -> None:
    """Host-level fence across the group."""
    if active():
        dist.barrier(group=group)


def group_device(group=None) -> torch.device:
    """The device whose tensors the group's backend reduces: the current
    card under NCCL, else the CPU."""
    if active() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_allreduce_mean(x, *, group=None) -> np.ndarray:
    """Eager cross-rank mean of a host value (a number or array); returns
    numpy. For occasional host-side aggregation, not the hot loop."""
    t = torch.as_tensor(np.asarray(x, dtype=np.float64), device=group_device(group))
    return reduce_mean(t, group=group, kind="host").cpu().numpy()


def broadcast_module(module: torch.nn.Module, src: int = 0, *, group=None) -> None:
    """Copy rank ``src``'s parameters and buffers into every rank's module,
    in place: DDP's construction-time broadcast (the JAX trainer's
    ``_place_state``)."""
    if not active():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)


def sync_group(sync: bool) -> Optional[object]:
    """The group SyncBN averages over: the world when ``sync`` and a
    process group exists, else None (per-rank statistics)."""
    return dist.group.WORLD if sync and active() else None


# -- sequence parallelism: the ring and the tiled all-to-all ----------------------


def _exchange(sends: list, dst, recvs: list, src, group, kind: str) -> None:
    """One ``batch_isend_irecv``: ``sends`` to the default group's rank
    ``dst`` and ``recvs`` filled in place from ``src`` (either list may be
    empty). Counted once under ``comm.ppermute.<kind>`` when anything
    moves."""
    ops = ([dist.P2POp(dist.isend, t, dst, group) for t in sends]
           + [dist.P2POp(dist.irecv, t, src, group) for t in recvs])
    if not ops:
        return
    counters.inc(f"comm.ppermute.{kind}")
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def rotate(tensors, *, group=None, shift: int = 1, kind: str = "ring") -> list:
    """Each tensor of this rank sent to the rank ``shift`` places on in the
    group (mod its size), and the one of the rank ``shift`` places back
    received in its place: one ``batch_isend_irecv`` of every tensor.
    At a group size of 1 the tensors come back as they are (``ppermute``
    with the perm ``0 -> 0``). Counted under ``comm.ppermute.<kind>``."""
    n = world_size(group)
    if n == 1:
        return list(tensors)
    me = rank(group)
    peer = functools.partial(dist.get_global_rank, group) if group is not None else int
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    _exchange(sends, peer((me + shift) % n), recvs, peer((me - shift) % n), group, kind)
    return recvs


class _RingRotate(torch.autograd.Function):
    """:func:`rotate` by +1, whose backward rotates the cotangents by -1:
    the transpose of ``lax.ppermute`` with the perm ``i -> i+1``."""

    @staticmethod
    def forward(ctx, group, kind, *tensors):
        ctx.group, ctx.kind = group, kind
        return tuple(rotate(tensors, group=group, kind=kind))

    @staticmethod
    def backward(ctx, *grads):
        back = rotate(grads, group=ctx.group, shift=-1, kind=ctx.kind + "_grad")
        return (None, None, *back)


def ring_rotate(*tensors, group=None, kind: str = "ring") -> tuple:
    """``tensors`` rotated one place around the ring of ``group``: this
    rank's go to the next rank, the previous rank's arrive here
    (``lax.ppermute(x, axis, [(i, (i + 1) % n)])``). Differentiable."""
    if world_size(group) == 1:
        return tuple(tensors)
    return _RingRotate.apply(group, kind, *tensors)


def _a2a_tiled(x, split_axis: int, concat_axis: int, group, kind: str):
    n = world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all of {x.shape[split_axis]} along axis {split_axis} "
                         f"over {n} ranks")
    rows = torch.stack(x.chunk(n, dim=split_axis))  # row j goes to rank j
    got = all_to_all(rows, group=group, kind=kind)  # row i came from rank i
    return torch.cat(got.unbind(0), dim=concat_axis)


class _AllToAllTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group, kind):
        ctx.args = (split_axis, concat_axis, group, kind)
        return _a2a_tiled(x, split_axis, concat_axis, group, kind)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, group, kind = ctx.args
        return _a2a_tiled(g, concat_axis, split_axis, group, kind + "_grad"), None, None, None, None


def all_to_all_tiled(x: torch.Tensor, split_axis: int, concat_axis: int, *, group=None,
                     kind: str = "other") -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``: ``x``
    cut into ``n`` equal blocks along ``split_axis``, block ``j`` sent to
    rank ``j``, and the blocks received joined in rank order along
    ``concat_axis``. Differentiable: the backward is the inverse exchange
    (``split_axis`` and ``concat_axis`` swapped), as JAX transposes it."""
    return _AllToAllTiled.apply(x, split_axis, concat_axis, group, kind)


# -- tensor parallelism: the Megatron conjugate pair ------------------------------


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce sum backward (counted ``<kind>_grad``):
    the "f" operator of ``tpu_dist/parallel/tensor.py::tp_ops``, which feeds
    a replicated activation into column-parallel layers and sums each
    shard's partial cotangent on the way back."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        return all_reduce_(out, group=ctx.group, kind=ctx.kind + "_grad"), None, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce sum forward (counted ``<kind>``), identity backward: the
    "g" operator, which merges row-parallel partial outputs; their
    cotangent is already the same on every shard."""

    @staticmethod
    def forward(ctx, x, group, kind):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group=group,
                           kind=kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_tp(x: torch.Tensor, *, group=None, kind: str = "tp") -> torch.Tensor:
    """``x`` as it is, whose gradient is summed over ``group`` (the model
    group); the identity without a process group or at a group of one."""
    return _CopyToTP.apply(x, group, kind) if active() and world_size(group) > 1 else x


def reduce_from_tp(x: torch.Tensor, *, group=None, kind: str = "tp") -> torch.Tensor:
    """``x`` summed over ``group`` (the model group), whose gradient passes
    as it is; the identity without a process group or at a group of one."""
    return _ReduceFromTP.apply(x, group, kind) if active() and world_size(group) > 1 else x


# -- pipeline parallelism: the stage handoff and the conjugate pair over a pipe group --


class _StageHandoff(torch.autograd.Function):
    """One pipeline tick's exchange over a pipe group: ``y`` (None: nothing)
    to the default group's rank ``nxt``, and a tensor of ``recv_like``'s
    shape, dtype and device from ``prv`` (None: nothing), in one
    ``batch_isend_irecv``; the backward sends the received tensor's
    cotangent back to ``prv`` and receives ``y``'s from ``nxt``, the
    transpose of ``lax.ppermute``. ``ticket`` (a 0-dim tensor) passes
    through, so every tick's exchange hangs on the one before it and a
    rank's backward runs its exchanges in reverse tick order, as its
    neighbours do."""

    @staticmethod
    def forward(ctx, ticket, y, recv_like, peers, group, kind):
        nxt, prv = peers
        sends = [y.contiguous()] if nxt is not None else []
        recvs = ([torch.empty(recv_like[0], dtype=recv_like[1], device=recv_like[2])]
                 if prv is not None else [])
        _exchange(sends, nxt, recvs, prv, group, kind)
        ctx.sent = (y.shape, y.dtype, y.device) if sends else None
        ctx.received = bool(recvs)
        ctx.peers, ctx.group, ctx.kind = peers, group, kind
        return ticket.clone(), (recvs[0] if recvs else None)

    @staticmethod
    def backward(ctx, g_ticket, g_h):
        nxt, prv = ctx.peers
        sends = [g_h.contiguous()] if ctx.received else []
        recvs = [torch.empty(ctx.sent[0], dtype=ctx.sent[1], device=ctx.sent[2])] if ctx.sent else []
        _exchange(sends, prv, recvs, nxt, ctx.group, ctx.kind + "_grad")
        return g_ticket, (recvs[0] if recvs else None), None, None, None, None


def stage_handoff(ticket: torch.Tensor, y: Optional[torch.Tensor], recv_like: torch.Tensor, *,
                  group=None, nxt=None, prv=None, kind: str = "pipe") -> tuple:
    """A pipeline tick's handoff: ``y`` to the next stage (the default
    group's rank ``nxt``; None sends nothing) and the previous stage's
    output received from rank ``prv`` (None receives nothing), shaped as
    ``recv_like``. Returns ``(ticket, received or None)``; ``ticket``
    threads the ticks' exchanges into one chain (:class:`_StageHandoff`).
    Differentiable; counted ``comm.ppermute.<kind>`` forward and
    ``<kind>_grad`` backward, once a tick that moves anything."""
    if nxt is None and prv is None:
        return ticket, None
    like = (tuple(recv_like.shape), recv_like.dtype, recv_like.device)
    return _StageHandoff.apply(ticket, y, like, (nxt, prv), group, kind)


def copy_to_pipe(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """:func:`copy_to_tp` over a pipe group, counted ``comm.all_reduce.
    pipe_grad``: the microbatches fed to the first stage, whose cotangent
    (the first stage's) every stage then holds."""
    return copy_to_tp(x, group=group, kind="pipe")


def reduce_from_pipe(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """:func:`reduce_from_tp` over a pipe group, counted ``comm.all_reduce.
    pipe``: the last stage's outputs (zeros on the others) summed, so every
    stage holds them."""
    return reduce_from_tp(x, group=group, kind="pipe")
