"""The train and eval steps: the port's counterpart of
``tpu_dist/train/step.py`` (``make_train_step``, ``make_eval_step``) on the
data-parallel (DP) family, one process per device.

* The loss casts the images to ``compute_dtype``; the model casts each
  weight to the activation dtype where it uses it (``nn/vit.py``,
  ``nn/layers.py``), exactly where the JAX step casts the parameter tree,
  so f32 master weights take f32 gradients. There is no autocast and no
  loss scaling.
* Models with BatchNorm (their running statistics are the module's
  buffers, ``state.bn_state``) take ``group=``: with ``sync_bn`` their
  statistics are averaged over the process group (SyncBN), without it each
  rank keeps its own and the running statistics are averaged over the
  ranks after the step (``tpu_dist/train/step.py:638-642``).
* Gradient accumulation over ``grad_accum_steps`` K chunks sums the K
  chunk gradients and divides by K (BN state threads through the chunks);
  the loss is the mean of the K chunk losses, and the metrics read all
  chunks' logits.
* The DDP gradient reduce runs ONCE per step, after the K chunks (torch's
  ``no_sync`` semantics): a mean over the ranks, by one all-reduce of one
  flat buffer (``pmean_fusion="fused"``) or one all-reduce per leaf
  (``"per_leaf"``). ``torch.autograd.grad`` takes the gradients, so the
  model is never wrapped in ``DistributedDataParallel`` (whose reducer
  hooks it would bypass, and whose ``broadcast_buffers`` copies rank 0's
  BN statistics where the JAX package averages them).
* ``grad_compression`` puts that reduce on a compressed wire, as the JAX
  step does (:func:`compressed_pmean`): ``bf16`` casts the gradients for
  the all-reduce; ``int8`` and ``int8_ef`` run the two-stage quantized
  reduce (:func:`quantized_pmean_flat`: per-chunk int8 with stochastic
  rounding, an all-to-all of the rows, a local f32 sum, a re-quantized
  all-gather), ``int8_ef`` with the error-feedback residuals of
  ``state.ef``. The rounding draws are keyed on the step count and the
  rank (:func:`quant_key`).
* ``shard_weight_update`` is ZeRO-1 (:class:`_ZeroOne`): the gradients,
  raveled and padded, are reduce-scattered (in ``rs_ag_chunks`` column
  groups, or on the int8 wire), each rank updates its shard of the flat
  parameters with its shard of the flat optimizer state (``state.opt_state``,
  :func:`init_sharded_opt_state`), and an all-gather rebuilds the
  parameters.
* ``grad_clip_norm`` clips the reduced gradients by their global norm
  (under ZeRO-1 from the shards' norms, one all-reduce).
* ``remat`` runs each chunk's forward and loss under
  ``torch.utils.checkpoint`` (non-reentrant), as the JAX step wraps its
  loss in ``jax.checkpoint``: the activations are recomputed in the
  backward instead of kept. The recomputed forward leaves the BN running
  statistics alone (:func:`~tpu_dist_torch.nn.layers.running_stats_frozen`),
  so they are the plain step's bit for bit; its SyncBN all-reduces run
  again, on every rank in the same order, as JAX's recomputed ``pmean``
  does, so ``comm.all_reduce.bn`` counts twice the plain step's (the
  forward's and the recomputation's) and ``bn_grad`` the same.
* Metrics are 0-dim tensors on the device (no host sync), reduced in one
  all-reduce: ``loss`` the mean over ranks, ``acc1``/``acc5`` in percent of
  the global batch, and ``preempt`` the number of ranks that had seen
  SIGTERM (:mod:`tpu_dist_torch.resilience.preemption`) when they built
  the step's metrics, so every rank reads the same stop decision at the
  same step boundary with no collective of its own.
* ``seq_axis`` (the seq axis of a ``[world/sp, sp]`` mesh,
  :func:`tpu_dist_torch.comm.mesh.seq_axis`) makes it the DP x SP step of
  the JAX ``make_train_step(seq_axis=...)``: the batch is sharded over the
  data axis and the same on every rank of a seq group, and the model runs
  sequence-parallel attention (``sp_mode`` ring or ulysses). Each seq
  rank's gradients are a full-loss replica's, so the mean over the data
  axis and then the seq axis that JAX takes is the one mean over every
  rank the step already takes. Under ZeRO-1 (``axis``, the data axis,
  whose ranks hold the flat shards) they are meant over the seq axis
  first, then reduce-scattered over the data axis. The quantized wires
  refuse a seq axis, as in JAX.
* ``tp_axis`` is Megatron tensor parallelism (the model holds its shards
  and joins its model group: ``ViT(tp=)``), ``ep_axis`` expert parallelism
  (``ViTMoE(ep=)``); ``axis`` is then the group of the ranks that share
  this rank's model index, over which the gradients are meant (under EP
  the expert slabs divided by the group's size, the other leaves meant
  over every rank), and the clip sums each sharded group's squares over its
  model group (:func:`make_step_body`). A model that returns ``(logits,
  aux)`` in training has ``moe_aux_coef`` times ``aux`` added to its loss.
* ``pp_axis`` is pipeline parallelism (the pipe axis of a ``[data, pipe]``
  or ``[data, pipe, model]`` mesh, :func:`tpu_dist_torch.comm.mesh.pp_mesh`):
  the model holds this rank's stage and streams the batch through the pipe
  group itself (``ViTPipeline(pipe=)``, ``n_microbatches`` in
  ``model_kwargs``), every rank of a data row on the same batch; it
  composes with ``tp_axis`` (Megatron PP×TP). Each rank differentiates its
  own replica of the loss: the stage leaves take their stage's gradients,
  the replicated leaves the same gradients on every rank of the group (the
  conjugate pair around the pipeline), so the gradients are meant over
  ``axis``, the data axis, alone; the clip sums each stage's squares over
  the pipe group (over the joined ``pipe,model`` group for the TP shards).
* ``device_metrics`` computes the training-health scalars
  (:func:`~tpu_dist_torch.obs.device_stats.compute_device_stats`:
  ``grad_norm``, ``param_norm``, ``update_ratio``, ``nonfinite_grads``)
  from the reduced, clipped gradients and the update, and appends them to
  the metrics vector after its all-reduce: they are the same on every rank
  already, so they take no collective (a sum would multiply them by the
  world) and no fetch of their own. The update is in place, so the step
  keeps a copy of the parameters from before it, with the flag on only.
  Scoped to the replicated-parameter paths, as in the JAX step.

The step is :func:`make_step_body` (the work on device tensors, ending in
the metrics all-reduce, with nothing read back to the host) inside
:func:`make_train_step` (placement, the metrics dict, the step counter).
The fused epoch (:mod:`tpu_dist_torch.train.epoch`) runs the same body in
a CUDA graph, built without the SIGTERM flag, whose host read a graph
would freeze.

Without a process group every collective is the identity (a world of one
process). The step updates the model, its BN statistics, its optimizer
state and its residuals in place (the JAX step's ``donate=True``) and
returns a state with ``step + 1``. The JAX step's walls stand: int8 with
``pmean_fusion="per_leaf"`` or a seq, model, expert or pipe axis,
``rs_ag_chunks > 1`` off the non-quantized ZeRO-1 path, ZeRO-1 with a
model, expert or pipe axis, an expert axis with a seq or model axis, and a
pipe axis with a seq or expert axis, raise ``ValueError``.
:class:`NotPortedError` names a flag whose subsystem is not ported and the
ROADMAP queue that owns it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.utils.checkpoint

import numpy as np

from tpu_dist_torch.comm import collectives, mesh
from tpu_dist_torch.comm.quantize import (DEFAULT_CHUNK, StreamKey, dequantize_int8,
                                          padded_len, quantize_int8)
from tpu_dist_torch.nn import functional as F
from tpu_dist_torch.nn import layers
from tpu_dist_torch.obs.device_stats import compute_device_stats, snapshot
from tpu_dist_torch.resilience import preemption
from tpu_dist_torch.train.state import FlatLayout, TrainState

GRAD_COMPRESSION_MODES = ("none", "bf16", "int8", "int8_ef")
# the modes that take the quantized two-stage reduce
QUANTIZED_MODES = ("int8", "int8_ef")
_QUANT_KEY_SEED = 0x1D8  # the stochastic-rounding stream's seed, folded per step
# the JAX step's refusal of device_metrics off the replicated-parameter paths
DEVICE_METRICS_SCOPE = ("device_metrics is scoped to the replicated-param paths (plain DP/SP, "
                        "any grad_compression) — it cannot combine with "
                        "shard_weight_update/tp/ep/pp")

# the JAX step's refusal of a pipe axis beside ZeRO-1, a seq or an expert axis
PP_SCOPE = ("pp_axis is incompatible with shard_weight_update / seq_axis / ep_axis "
            "(structural; see docstring)")


class NotPortedError(NotImplementedError):
    """An option whose subsystem is not ported yet: names the flag and the
    ROADMAP item it waits for (``queue``), instead of being a silent
    no-op."""

    def __init__(self, flag: str, value, queue: str):
        self.flag = flag
        self.queue = queue
        super().__init__(
            f"{flag}={value!r} is not ported to tpu_dist_torch yet; it waits for "
            f"ROADMAP.md {self.queue}"
        )


def check_seq_axis(seq_axis, axis, sp_mode: str, grad_compression: str,
                   shard_weight_update: bool, model_axes: tuple = ()) -> None:
    """The JAX step's walls around ``seq_axis`` and the model axes
    (``model_axes``: the tp, ep and pp axes given): the quantized wires combine
    with none of them (``tpu_dist/train/step.py:413-422``), ``sp_mode`` is
    ring or ulysses, and ZeRO-1 under a seq axis needs the data axis of
    the same mesh."""
    if seq_axis is None and not any(a is not None for a in model_axes):
        return
    if seq_axis is not None and sp_mode not in ("ring", "ulysses"):
        raise ValueError(f"sp_mode must be 'ring' or 'ulysses', got {sp_mode!r}")
    if seq_axis is not None and shard_weight_update and axis is None:
        raise ValueError("shard_weight_update with seq_axis needs axis=, the data axis of the "
                         "same mesh (tpu_dist_torch.comm.mesh.data_axis)")
    if grad_compression in QUANTIZED_MODES:
        # the flat two-stage reduce assumes one reduce axis
        raise ValueError(
            f"grad_compression={grad_compression!r} is scoped to the plain data-parallel and "
            "ZeRO-1 paths; it cannot combine with sp/tp/ep/pp (use grad_compression='bf16' "
            "there)"
        )


def _to(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device, dtype=dtype)


def _flat_all_reduce_mean(tensors, kind: str, group=None) -> list:
    """One all-reduce over the concatenation of ``tensors`` in ``group``
    (every rank by default), divided by its size; returns contiguous views
    of the reduced buffer in their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collectives.all_reduce_(flat, group=group, kind=kind).div_(collectives.world_size(group))
    return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def validate_grad_compression(mode: str) -> None:
    if mode not in GRAD_COMPRESSION_MODES:
        raise ValueError(f"grad_compression must be one of {GRAD_COMPRESSION_MODES}, got {mode!r}")


def grad_wire(g: torch.Tensor, mode: str) -> torch.Tensor:
    """The gradient's wire format for a cross-rank reduce: bf16 under
    ``'bf16'`` (the int8 modes take :func:`quantized_pmean_flat`)."""
    return g.to(torch.bfloat16) if mode == "bf16" else g


def grad_unwire(g: torch.Tensor, like: torch.Tensor, mode: str) -> torch.Tensor:
    """The update's dtype again after a compressed reduce."""
    return g.to(like.dtype) if mode == "bf16" else g


def _params_of(params) -> list:
    return list(params.parameters()) if hasattr(params, "parameters") else list(params)


def flat_layout(params, world: Optional[int] = None, rank: Optional[int] = None) -> FlatLayout:
    """The lay-out of ``params`` (a module or tensors) raveled and padded
    over the process group (or ``world`` ranks, this one ``rank``)."""
    return FlatLayout(sum(p.numel() for p in _params_of(params)),
                      collectives.world_size() if world is None else int(world),
                      collectives.rank() if rank is None else int(rank))


def axis_layout(params, axis=None) -> FlatLayout:
    """:func:`flat_layout` over the data axis ``axis`` (an
    :class:`~tpu_dist_torch.comm.mesh.AxisGroup`; None: every rank)."""
    if axis is None:
        return flat_layout(params)
    return flat_layout(params, axis.size, axis.index)


def ef_state_host_zeros(params, n: int, *, zero1: bool = False) -> dict:
    """Zero residuals in the JAX package's GLOBAL layout at a data-parallel
    extent of ``n`` (numpy, as a checkpoint holds them): ``r1`` of
    ``n·P`` (one padded-gradient row a replica), ``r2`` of ``P``
    (``P = padded_len(L, n)``); ZeRO-1 keeps ``r1`` only."""
    P = padded_len(sum(p.numel() for p in _params_of(params)), n)
    ef = {"r1": np.zeros((n * P,), np.float32)}
    if not zero1:
        ef["r2"] = np.zeros((P,), np.float32)
    return ef


def init_ef_state(params, *, zero1: bool = False, layout: Optional[FlatLayout] = None) -> dict:
    """This rank's zero residuals, on the parameters' device: ``r1`` its
    row (``layout.padded``), ``r2`` its shard (``layout.chunk``)."""
    params = _params_of(params)
    layout = layout or flat_layout(params)
    dev = params[0].device
    ef = {"r1": torch.zeros(layout.padded, dtype=torch.float32, device=dev)}
    if not zero1:
        ef["r2"] = torch.zeros(layout.chunk, dtype=torch.float32, device=dev)
    return ef


def init_sharded_opt_state(params, optimizer=None, *, layout: Optional[FlatLayout] = None):
    """This rank's shard of the ZeRO-1 flat optimizer state, zeros on the
    parameters' device: SGD's momentum (``layout.chunk`` f32), or the
    optimizer's own flat state (AdamW's ``init_flat_state``)."""
    params = _params_of(params)
    layout = layout or flat_layout(params)
    dev = params[0].device
    if optimizer is not None and hasattr(optimizer, "init_flat_state"):
        return optimizer.init_flat_state(layout.chunk, dev)
    return torch.zeros(layout.chunk, dtype=torch.float32, device=dev)


def _chunk_bounds(total: int, k: int) -> list:
    """``[0, total)`` in at most ``k`` contiguous groups of near-equal width
    (the remainder over the first groups, no padding)."""
    k = max(1, min(k, total))
    base, rem = divmod(total, k)
    bounds, lo = [], 0
    for i in range(k):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def quant_key(step, rank: Optional[int] = None) -> StreamKey:
    """The step's stochastic-rounding key: the seed, folded with the step
    count (an int, or a 0-d device tensor a graph replays), then the rank."""
    return StreamKey(_QUANT_KEY_SEED).fold(step).fold(
        collectives.rank() if rank is None else rank)


def _ravel(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unravel(flat: torch.Tensor, like) -> list:
    """Views of ``flat`` in the shapes of ``like``."""
    return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in like]), like)]


def _quantized_reduce_scatter_rows(rows: torch.Tensor, key, chunk: int, group=None):
    """The quantized reduce-scatter of ``rows`` ``(n, m)`` over ``group``:
    quantize, an int8 all-to-all (and one of the f32 scales), a local
    dequantize-sum. Returns ``(this rank's reduced shard (m,), its
    dequantized transmission (n, m))``, the second for the error feedback."""
    q, s = quantize_int8(rows, chunk, key)
    qt = collectives.all_to_all(q, group=group, kind="grad")
    st = collectives.all_to_all(s, group=group, kind="grad_scale")
    reduced = torch.sum(dequantize_int8(qt, st, chunk), dim=0)
    return reduced, dequantize_int8(q, s, chunk)


def quantized_pmean_flat(grads, *, key, ef, chunk: int):
    """The two-stage quantized mean of ``grads`` (tensors) over the ranks,
    ``tpu_dist/train/step.py::quantized_pmean_flat``: ravel, pad to a
    multiple of the world ``n`` and scale by 1/n; leg 1 quantizes the rows
    and reduce-scatters them (:func:`_quantized_reduce_scatter_rows`,
    ``key.fold(1)``); leg 2 re-quantizes the reduced shard
    (``key.fold(2)``) and all-gathers it. ``ef`` is ``()`` or this rank's
    ``{"r1", "r2"}``: added before each leg's quantization, and the
    realised errors returned as the new residuals. Returns ``(mean grads
    in ``grads``' shapes, new_ef)``."""
    n = collectives.world_size()
    flat = _ravel(grads)
    L = flat.numel()
    P = padded_len(L, n)
    m = P // n
    x = torch.nn.functional.pad(flat, (0, P - L)) / n
    if ef:
        x = x + ef["r1"]
    reduced, sent = _quantized_reduce_scatter_rows(x.view(n, m), key.fold(1), chunk)
    new_ef = ()
    if ef:
        new_ef = {"r1": x - sent.reshape(P)}
        reduced = reduced + ef["r2"]
    q2, s2 = quantize_int8(reduced, chunk, key.fold(2))
    if ef:
        new_ef["r2"] = reduced - dequantize_int8(q2, s2, chunk)
    qg = collectives.all_gather_flat(q2, kind="grad")
    sg = collectives.all_gather_flat(s2, kind="grad_scale")
    full = dequantize_int8(qg.view(n, m), sg.view(n, -1), chunk).reshape(P)[:L]
    return _unravel(full, grads), new_ef


def compressed_pmean(grads, mode: str, *, key=None, ef=(), chunk: Optional[int] = None,
                     pmean_fusion: str = "fused"):
    """The cross-rank gradient mean on ``mode``'s wire, the entry point of
    the streaming and the fused step: ``none`` and ``bf16`` one all-reduce
    of the (cast) flat gradients (one a leaf with ``per_leaf``), the int8
    modes :func:`quantized_pmean_flat` (``key`` required; ``ef`` used
    under ``int8_ef`` only). Returns ``(contiguous mean grads, new_ef)``,
    ``new_ef`` the ``ef`` given except under ``int8_ef``."""
    if mode in QUANTIZED_MODES:
        return quantized_pmean_flat(grads, key=key, ef=ef if mode == "int8_ef" else (),
                                    chunk=chunk or DEFAULT_CHUNK)
    if mode == "none" and not collectives.active():
        return [g.contiguous() for g in grads], ef
    wired = [grad_wire(g, mode) for g in grads]
    if pmean_fusion == "fused":
        red = _flat_all_reduce_mean(wired, "grad")
    else:
        world = collectives.world_size()
        red = [collectives.all_reduce_(g.contiguous(), kind="grad").div_(world) for g in wired]
    return [grad_unwire(r, g, mode).contiguous() for r, g in zip(red, grads)], ef


class _ZeroOne:
    """ZeRO-1 weight-update sharding for one model, the JAX step's
    ``_sharded_update``: the persistent buffers of this rank's shard (the
    parameters and the reduced gradients, ``layout.chunk`` each, so the
    fused SGD kernel's launch plan holds between steps) and the update,
    over the data axis ``axis`` (None: every rank). With a ``seq_group``
    the gradients are first meant over it (on the wire), as the JAX step
    does before its reduce-scatter."""

    def __init__(self, optimizer, model, *, mode: str, q_chunk: int, rs_ag_chunks: int,
                 clip: float, axis=None, seq_group=None):
        self.model, self.optimizer, self.mode, self.q_chunk = model, optimizer, mode, q_chunk
        self.rs_ag_chunks, self.clip = rs_ag_chunks, clip
        self.group = axis.group if axis is not None else None
        self.seq_group = seq_group
        params = list(model.parameters())
        self.layout = lay = axis_layout(params, axis)
        dev = params[0].device
        self.p_shard = torch.zeros(lay.chunk, dtype=torch.float32, device=dev)
        self.g_shard = torch.zeros(lay.chunk, dtype=torch.float32, device=dev)
        self.bounds = _chunk_bounds(lay.chunk, rs_ag_chunks)
        self.wd = None
        if hasattr(optimizer, "leaf_wd_intervals"):
            # the decay mask in flat coordinates, this rank's part of it
            wd = torch.zeros(lay.padded, dtype=torch.float32)
            for start, end, w in optimizer.leaf_wd_intervals(params):
                wd[start:end] = w
            self.wd = wd[lay.lo:lay.lo + lay.chunk].to(dev)

    def update(self, state: TrainState, params: list, grads: list, lr, step) -> None:
        lay, mode, group = self.layout, self.mode, self.group
        n, L, chunk = lay.world, lay.L, lay.chunk
        if self.seq_group is not None:
            # each seq rank holds a full-loss replica's gradients: their
            # mean over the group is the gradient
            grads = [grad_unwire(r, g, mode) for r, g in zip(_flat_all_reduce_mean(
                [grad_wire(g, mode) for g in grads], "grad_seq", self.seq_group), grads)]
        x = torch.nn.functional.pad(_ravel(grads) / n, (0, lay.padded - L))
        if mode in QUANTIZED_MODES:
            if mode == "int8_ef":
                x = x + state.ef["r1"]
            g, sent = _quantized_reduce_scatter_rows(x.view(n, chunk), quant_key(step, lay.rank),
                                                     self.q_chunk, group)
            if mode == "int8_ef":
                state.ef["r1"].copy_(x - sent.reshape(-1))
            self.g_shard.copy_(g)
        elif self.rs_ag_chunks > 1:
            # column groups of the (n, chunk) rows: shard p of group [c0:c1)
            # is rows[p, c0:c1], so the pieces concatenate to this rank's shard
            rows = grad_wire(x, mode).view(n, chunk)
            self.g_shard.copy_(torch.cat([
                collectives.reduce_scatter(rows[:, c0:c1].reshape(-1), group=group, kind="grad")
                for c0, c1 in self.bounds]))
        elif mode == "bf16":
            self.g_shard.copy_(collectives.reduce_scatter(grad_wire(x, mode), group=group,
                                                          kind="grad"))
        else:
            collectives.reduce_scatter(x, group=group, kind="grad", out=self.g_shard)
        if self.clip > 0.0:  # the global norm from the shards' norms
            sq = collectives.all_reduce_(torch.sum(torch.square(self.g_shard)), group=group,
                                         kind="clip")
            self.g_shard.mul_(torch.clamp(self.clip / torch.clamp(torch.sqrt(sq), min=1e-12),
                                          max=1.0))
        with torch.no_grad():
            lo, hi = lay.lo, min(lay.lo + chunk, L)
            if hi > lo:  # the tail past L stays 0: its gradient and state are 0
                self.p_shard[:hi - lo].copy_(_ravel(params)[lo:hi])
        opt = state.opt_state
        kw = {"wd_tree": [self.wd]} if self.wd is not None else {}
        view = ({"mu": [opt["mu"]], "nu": [opt["nu"]], "count": opt["count"]}
                if isinstance(opt, dict) else [opt])
        self.optimizer.update([self.g_shard], view, [self.p_shard], lr, **kw)
        if self.rs_ag_chunks > 1:
            full = torch.cat([
                collectives.all_gather_flat(self.p_shard[c0:c1], group=group,
                                            kind="params").view(n, c1 - c0)
                for c0, c1 in self.bounds], dim=1).reshape(-1)
        else:
            full = collectives.all_gather_flat(self.p_shard, group=group, kind="params")
        with torch.no_grad():
            for p, v in zip(params, _unravel(full[:L], params)):
                p.copy_(v)


def make_step_body(
    optimizer,
    *,
    grad_accum_steps: int = 1,
    sync_bn: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    label_smoothing: float = 0.0,
    grad_clip_norm: float = 0.0,
    pmean_fusion: str = "fused",
    preempt_flag: bool = True,
    remat: bool = False,
    shard_weight_update: bool = False,
    grad_compression: str = "none",
    quant_chunk: Optional[int] = None,
    rs_ag_chunks: int = 1,
    device_metrics: bool = False,
    axis=None,
    seq_axis=None,
    sp_mode: str = "ring",
    tp_axis=None,
    ep_axis=None,
    pp_axis=None,
    moe_aux_coef: float = 0.01,
    model_kwargs: Optional[dict] = None,
):
    """Build ``body(state, images, labels, lr, step=None) -> sums``: the
    step on tensors already on the model's device. Forward and backward
    over the K chunks, the BN-state average without SyncBN, the gradient
    reduce (on the ``grad_compression`` wire), the clip and the
    optimizer's in-place update, or under ``shard_weight_update`` the
    ZeRO-1 reduce-scatter, shard update and all-gather; then ONE
    all-reduce of ``[loss, top-1 hits, top-5 hits]`` (f32, summed over the
    ranks), which it returns. With ``preempt_flag`` a 4th element carries
    this rank's SIGTERM flag as read on the host when the step is built;
    without it (a step captured in a CUDA graph, where that read would be
    frozen) the body reads nothing of the host's state and nothing back
    from the device, so a graph can hold it. ``lr`` must then be a device
    tensor (a float would be frozen into the graph too), and so must
    ``step``, the step count that keys the int8 rounding (default
    ``state.step``). ``remat`` recomputes each chunk's forward in its
    backward. ``device_metrics`` appends the four health scalars to the
    reduced sums (:func:`metrics_from_sums` names them).

    ``seq_axis`` (an :class:`~tpu_dist_torch.comm.mesh.AxisGroup`) runs
    the model sequence-parallel (``sp_mode``) on the batch, which is the
    same on every rank of the seq group; the gradient and metric reduces
    stay over every rank, whose seq replicas hold the same loss, hits and
    gradients. ``axis`` is the data axis ZeRO-1 shards over (None: every
    rank); under a seq axis ZeRO-1 means the gradients over the seq group
    before its reduce-scatter over ``axis``.

    ``tp_axis`` (the model axis of a ``[data, model]`` mesh,
    :func:`tpu_dist_torch.comm.mesh.tp_mesh`) is Megatron tensor
    parallelism: the model holds this rank's shards and joins the model
    group itself (``ViT(tp=...)``); the batch is the data row's on every
    rank of the group. The gradients are meant over ``axis``, the ranks
    that share this rank's model index (the data axis, or under TP x SP the
    joined ``data,seq`` group): the replicated leaves' gradients are the
    same on every model rank already (``copy_to_tp``'s backward), the
    shards' are this rank's. ``ep_axis`` (the expert axis of a ``[data,
    expert]`` mesh) is expert parallelism: each rank its own batch, the
    expert slabs sharded; the slabs' gradients take the mean over ``axis``
    (the data axis) divided by the expert group's size (each rank's slabs
    gather the whole group's tokens through the exchange's backward, the
    sum of every rank's loss gradient), every other leaf the mean over
    every rank (``tpu_dist/train/step.py::_ep_grad_reduce``). ``pp_axis``
    (the pipe axis of :func:`tpu_dist_torch.comm.mesh.pp_mesh`, with or
    without ``tp_axis``) is pipeline parallelism: the model holds this rank's
    stage and its replicated leaves; every rank of a data row takes its
    batch, and the gradients are meant over ``axis`` (the data axis). The
    global-norm clip sums each sharded group's squares over its group: the
    model group, the pipe group, or for PP×TP's shards the joined
    ``pipe,model`` group (:func:`_leaf_groups`). ``model_kwargs`` go to
    the model's forward (the pipeline's ``n_microbatches``). A model that
    returns ``(logits, aux)`` in training (the MoE ViT) has
    ``moe_aux_coef`` times ``aux`` added to each chunk's loss."""
    validate_grad_compression(grad_compression)
    quantized = grad_compression in QUANTIZED_MODES
    check_seq_axis(seq_axis, axis, sp_mode, grad_compression, shard_weight_update,
                   (tp_axis, ep_axis, pp_axis))
    if pp_axis is not None and (shard_weight_update or seq_axis is not None
                                or ep_axis is not None):
        raise ValueError(PP_SCOPE)
    model_axis = tp_axis if tp_axis is not None else ep_axis
    if model_axis is not None and shard_weight_update:
        raise ValueError(
            ("tp_axis + shard_weight_update is out of ZeRO-1's scope (DP-only fast path by "
             "design) — use --fsdp for sharded weight updates beyond plain DP")
            if tp_axis is not None else
            "ep_axis is incompatible with shard_weight_update / seq_axis / tp_axis "
            "(structural; see docstring)")
    model_axes = [a for a in (tp_axis, ep_axis, pp_axis) if a is not None]
    if (model_axes and axis is None
            and collectives.world_size() != math.prod(a.size for a in model_axes)):
        flag = "pp_axis" if pp_axis is not None else "tp_axis" if tp_axis is not None else "ep_axis"
        raise ValueError(f"{flag} needs axis=, the ranks that share this rank's model index (the "
                         "data axis of the same mesh, tpu_dist_torch.comm.mesh.tp_mesh / "
                         "ep_mesh / pp_mesh)")
    if device_metrics and shard_weight_update:
        # the health scalars are free only where the reduced gradients and
        # the parameters are the same on every rank; under ZeRO-1 they
        # exist as shards, and the global norms would need collectives
        raise ValueError(DEVICE_METRICS_SCOPE)
    if pmean_fusion not in ("fused", "per_leaf"):
        raise ValueError(f"pmean_fusion={pmean_fusion!r}: expected 'fused' or 'per_leaf'")
    if pmean_fusion == "per_leaf" and (quantized or shard_weight_update or ep_axis is not None):
        raise ValueError("pmean_fusion='per_leaf' is scoped to the non-quantized data-parallel "
                         "reduce; it cannot combine with grad_compression int8/ep/"
                         "shard_weight_update")
    rs_ag_chunks = int(rs_ag_chunks)
    if rs_ag_chunks < 1:
        raise ValueError(f"rs_ag_chunks={rs_ag_chunks}: must be >= 1")
    if rs_ag_chunks > 1 and not (shard_weight_update and not quantized):
        raise ValueError("rs_ag_chunks > 1 is scoped to the non-quantized ZeRO-1 path "
                         "(shard_weight_update=True, grad_compression none/bf16)")
    q_chunk = int(quant_chunk) if quant_chunk else DEFAULT_CHUNK
    K = int(grad_accum_steps)
    if K < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    zero = {}  # the _ZeroOne of the model the body last saw
    leaf_groups = {}  # the sharded leaves' groups of the model the body last saw
    seq_group = seq_axis.group if seq_axis is not None else None
    model_kw = {"seq": seq_axis, "sp_mode": sp_mode} if seq_axis is not None else {}
    model_kw.update(model_kwargs or {})
    data_group = axis.group if axis is not None else None

    def wired_mean(grads, kind, group, div=1):
        """The mean over ``group`` on the wire, divided by ``div``."""
        red = _flat_all_reduce_mean([grad_wire(g, grad_compression) for g in grads], kind, group)
        out = [grad_unwire(r, g, grad_compression) for r, g in zip(red, grads)]
        return [o.div_(div) for o in out] if div != 1 else out

    def reduce_grads(grads, state, step, sharded_ix):
        """The gradient reduce on the ``grad_compression`` wire, once a step:
        under TP and PP the mean over the data axis (none without ``axis``:
        the model's ranks are then the world, one data row), under EP the
        mean over the data axis divided by the group's size for the expert
        slabs (``sharded_ix``) and over every rank for the rest, else the
        mean over every rank (:func:`compressed_pmean`), whose ``int8_ef``
        residuals go back into ``state.ef`` in place."""
        if tp_axis is not None or pp_axis is not None:
            if not collectives.active() or axis is None:
                return grads
            return wired_mean(grads, "grad", data_group)
        if ep_axis is not None:
            if not collectives.active():
                return grads
            out = list(grads)
            slabs = [grads[i] for i in sharded_ix]
            rest = [i for i in range(len(grads)) if i not in sharded_ix]
            for i, r in zip(rest, wired_mean([grads[i] for i in rest], "grad", None)):
                out[i] = r
            for i, r in zip(sharded_ix, wired_mean(slabs, "grad_ep", data_group, ep_axis.size)):
                out[i] = r
            return out
        ef = state.ef if grad_compression == "int8_ef" else ()
        red, new_ef = compressed_pmean(
            grads, grad_compression, key=quant_key(step) if quantized else None, ef=ef,
            chunk=q_chunk, pmean_fusion=pmean_fusion)
        for k, v in (new_ef.items() if ef else ()):
            state.ef[k].copy_(v)
        return red

    def clip_grads(grads, groups=()):
        """Global-norm clip: scale = min(1, clip / max(norm, 1e-12)). The
        squares of each group's sharded leaves (``groups``: ``[(process
        group, indices)]``) are summed over that group first: each rank
        holds a slice of their norm, and the replicated leaves the whole of
        theirs (``tpu_dist/train/step.py::clip_grads``)."""
        if grad_clip_norm <= 0.0:
            return grads
        grouped = {i for _, ix in groups for i in ix}
        sq = sum(torch.sum(torch.square(g)) for i, g in enumerate(grads) if i not in grouped)
        for group, ix in groups:
            part = sum(torch.sum(torch.square(grads[i])) for i in ix)
            sq = sq + collectives.all_reduce_(part, group=group, kind="clip")
        scale = torch.clamp(grad_clip_norm / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0)
        return [g * scale for g in grads]

    def sharded(state: TrainState, params: list) -> _ZeroOne:
        z = zero.get("z")
        if z is None or z.model is not state.params:
            opt = state.opt_state
            mom = opt["mu"] if isinstance(opt, dict) else opt
            lay = axis_layout(params, axis)
            if not isinstance(mom, torch.Tensor) or tuple(mom.shape) != (lay.chunk,):
                raise ValueError("shard_weight_update needs this rank's flat optimizer state "
                                 f"({lay.chunk} elements: init_sharded_opt_state)")
            z = zero["z"] = _ZeroOne(optimizer, state.params, mode=grad_compression,
                                     q_chunk=q_chunk, rs_ag_chunks=rs_ag_chunks,
                                     clip=grad_clip_norm, axis=axis, seq_group=seq_group)
        return z

    def body(state: TrainState, images, labels, lr, step=None) -> torch.Tensor:
        model = state.params
        params = list(model.parameters())
        step = state.step if step is None else step
        if images.shape[0] % K:
            raise ValueError(f"batch {images.shape[0]} does not split into {K} chunks")
        n = images.shape[0] // K
        # BatchNorm models take the SyncBN group; the ViT has none
        fwd_kw = {"group": collectives.sync_group(sync_bn)} if state.bn_state else dict(model_kw)
        if leaf_groups.get("model") is not model:  # once a model: a walk of its leaves
            leaf_groups.update(model=model, groups=_leaf_groups(model, tp_axis, ep_axis, pp_axis))
        groups = leaf_groups["groups"]
        sharded_ix = [i for _, ix in groups for i in ix]
        model.train()

        def forward_loss(x, y):
            out = model(x.to(compute_dtype), **fwd_kw)
            aux = None
            if isinstance(out, tuple):  # the MoE ViT's load-balancing loss
                out, aux = out
            loss = F.cross_entropy(out, y, label_smoothing=label_smoothing)
            if aux is not None:
                loss = loss + moe_aux_coef * aux.to(loss.dtype)
            return loss, out

        grads, losses, logits = None, [], []
        for c in range(K):
            x, y = images[c * n:(c + 1) * n], labels[c * n:(c + 1) * n]
            with torch.enable_grad():
                if remat:
                    # the forward draws no random numbers: no RNG state to
                    # keep (keeping it would read the card's back each step)
                    loss, out = torch.utils.checkpoint.checkpoint(
                        forward_loss, x, y, use_reentrant=False, preserve_rng_state=False,
                        context_fn=lambda: (contextlib.nullcontext(),
                                            layers.running_stats_frozen(model)))
                else:
                    loss, out = forward_loss(x, y)
                g = torch.autograd.grad(loss, params)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            losses.append(loss.detach())
            logits.append(out.detach())
        if K > 1:
            grads = [g / K for g in grads]
        loss = torch.stack(losses).mean() if K > 1 else losses[0]
        if state.bn_state and not sync_bn and collectives.active():
            # per-rank statistics diverged: average them so every rank
            # holds the same running state (the JAX step's pmean)
            bufs = list(state.bn_state.values())
            with torch.no_grad():
                for b, avg in zip(bufs, _flat_all_reduce_mean(bufs, "bn_state")):
                    b.copy_(avg)
        stats = None
        if shard_weight_update:
            sharded(state, params).update(state, params, grads, lr, step)
        else:
            applied = clip_grads(reduce_grads(grads, state, step, sharded_ix), groups)
            if device_metrics:
                before = snapshot(params)  # the parameters before the in-place update
            optimizer.update(applied, state.opt_state, params, lr)
            if device_metrics:
                stats = compute_device_stats(applied, before, params)

        c1, c5 = F.topk_correct(torch.cat(logits).float(), labels, (1, 5))
        sums = [loss.float(), c1.float(), c5.float()]
        if preempt_flag:
            # a fill kernel carries the flag: no host-to-device copy
            sums.append(torch.full((), float(preemption.requested()), device=loss.device))
        reduced = collectives.all_reduce_(torch.stack(sums), kind="metrics")
        if stats is None:
            return reduced
        # the same on every rank already: after the all-reduce, not in it
        return torch.cat([reduced, torch.stack([stats[k] for k in DEVICE_STATS])])

    return body


def _check_axis(own, axis, flag: str, model) -> None:
    """Raise unless the model is sharded over ``own``, an axis of
    ``axis``'s name, size and index."""
    if own is None or not hasattr(model, "param_specs"):
        raise ValueError(f"{flag}_axis requires param_specs (per-leaf shardings): a "
                         f"{type(model).__name__} built with "
                         f"{'pipe' if flag == 'pp' else flag}= its group")
    if (own.name, own.size, own.index) != (axis.name, axis.size, axis.index):
        raise ValueError(f"the model is sharded over {own.name}={own.size} (index {own.index}), "
                         f"the step over {axis.name}={axis.size} (index {axis.index})")


def _leaf_groups(model, tp_axis, ep_axis, pp_axis) -> list:
    """``[(process group, parameter indices)]``, in ``model.parameters()``
    order, of the leaves sharded over a group: under ``pp_axis`` a stage's
    TP shards over the stage group (the joined ``pipe,model`` group) and its
    other leaves over the pipe group; under ``tp_axis`` or ``ep_axis`` the
    model's ``param_specs`` over the model group. Raises unless the model is
    sharded over axes of those names and sizes."""
    names = [n for n, _ in model.named_parameters()]
    if pp_axis is not None:
        _check_axis(getattr(model, "pipe", None), pp_axis, "pp", model)
        if tp_axis is not None:
            _check_axis(getattr(model, "tp", None), tp_axis, "tp", model)
        specs = model.pp_tp_param_specs() if tp_axis is not None else model.pp_param_specs()
        # leaves grouped by the model axes of their spec, as JAX's clip does
        by_axes: dict = {}
        for i, n in enumerate(names):
            if n in specs:
                by_axes.setdefault(specs[n][0], []).append(i)
        group_of = {mesh.PIPE_AXIS: model.pipe, (mesh.PIPE_AXIS, mesh.MODEL_AXIS): model.stage}
        return [(group_of[axes].group, ix) for axes, ix in by_axes.items()]
    model_axis = tp_axis if tp_axis is not None else ep_axis
    if model_axis is None:
        return []
    _check_axis(getattr(model, "shard_axis", None), model_axis,
                "tp" if model_axis.name == "model" else "ep", model)
    specs = model.param_specs()
    return [(model_axis.group, [i for i, n in enumerate(names) if n in specs])]


#: The ``device_metrics`` scalars, in the order ``body`` appends them.
DEVICE_STATS = ("grad_norm", "param_norm", "update_ratio", "nonfinite_grads")


def metrics_from_sums(sums: torch.Tensor, batch: int, device_metrics: bool = False) -> dict:
    """The step's metrics from ``body``'s all-reduced sums and the per-rank
    batch: ``loss`` the mean over the ranks, ``acc1``/``acc5`` in percent
    of the global batch (0-dim tensors); with ``device_metrics`` the health
    scalars ``body`` appended last, as they are."""
    world = collectives.world_size()
    out = {
        "loss": sums[0] / world,
        "acc1": sums[1] / (batch * world) * 100.0,
        "acc5": sums[2] / (batch * world) * 100.0,
    }
    if device_metrics:
        out.update(zip(DEVICE_STATS, sums[-len(DEVICE_STATS):]))
    return out


def make_train_step(
    optimizer,
    *,
    grad_accum_steps: int = 1,
    sync_bn: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    label_smoothing: float = 0.0,
    grad_clip_norm: float = 0.0,
    shard_weight_update: bool = False,
    seq_axis=None,
    tp_axis=None,
    ep_axis=None,
    pp_axis=None,
    remat: bool = False,
    grad_compression: str = "none",
    quant_chunk: Optional[int] = None,
    pmean_fusion: str = "fused",
    rs_ag_chunks: int = 1,
    device_metrics: bool = False,
    axis=None,
    sp_mode: str = "ring",
    moe_aux_coef: float = 0.01,
    model_kwargs: Optional[dict] = None,
):
    """Build ``step(state, images, labels, lr) -> (state, metrics)``.

    ``state.params`` is the model (``images [B, ...] -> logits``, this
    rank's share of the global batch); images and labels are tensors or
    arrays, moved to the model's device; ``lr`` is a float or a float32
    scalar tensor there. With ``shard_weight_update`` ``state.opt_state``
    is this rank's flat shard (:func:`init_sharded_opt_state`); with
    ``grad_compression="int8_ef"`` ``state.ef`` holds this rank's
    residuals (:func:`init_ef_state`). ``device_metrics`` adds the health
    scalars (:data:`DEVICE_STATS`) to the metrics.

    ``seq_axis`` is the seq axis of a DP x SP mesh
    (:func:`tpu_dist_torch.comm.mesh.seq_axis`), ``sp_mode`` the
    sequence-parallel attention (:func:`make_step_body`); ``images`` and
    ``labels`` are then this data row's batch, the same on every rank of
    the seq group. With ZeRO-1, ``axis`` is the mesh's data axis
    (:func:`tpu_dist_torch.comm.mesh.data_axis`), over which the flat state
    is sharded (``axis_layout``).

    ``tp_axis`` / ``ep_axis`` (:func:`~tpu_dist_torch.comm.mesh.tp_mesh`,
    :func:`~tpu_dist_torch.comm.mesh.ep_mesh`) run tensor or expert
    parallelism (:func:`make_step_body`), with ``axis`` the ranks that
    share this rank's model index; ``images`` and ``labels`` are then the
    data row's batch under TP, this rank's own under EP. ``pp_axis``
    (:func:`~tpu_dist_torch.comm.mesh.pp_mesh`'s ``pipe``, with or without
    ``tp_axis``) runs pipeline parallelism, the data row's batch on every
    rank, ``axis`` the mesh's data axis and the microbatch count
    ``model_kwargs={"n_microbatches": M}`` (default: the stage count).
    ``moe_aux_coef`` weighs a MoE model's load-balancing loss."""
    validate_grad_compression(grad_compression)
    if device_metrics and any(a is not None for a in (tp_axis, ep_axis, pp_axis)):
        raise ValueError(DEVICE_METRICS_SCOPE)  # make_step_body refuses ZeRO-1
    if ep_axis is not None and (seq_axis is not None or tp_axis is not None):
        # the MoE dispatch and the ring or the Megatron shards would thread
        # one token dimension through two layouts (tpu_dist/train/step.py:501-514)
        raise ValueError("ep_axis is incompatible with shard_weight_update / seq_axis / "
                         "tp_axis (structural; see docstring)")
    body = make_step_body(optimizer, grad_accum_steps=grad_accum_steps, sync_bn=sync_bn,
                          compute_dtype=compute_dtype, label_smoothing=label_smoothing,
                          grad_clip_norm=grad_clip_norm, pmean_fusion=pmean_fusion,
                          remat=remat, shard_weight_update=shard_weight_update,
                          grad_compression=grad_compression, quant_chunk=quant_chunk,
                          rs_ag_chunks=rs_ag_chunks, device_metrics=device_metrics,
                          axis=axis, seq_axis=seq_axis, sp_mode=sp_mode, tp_axis=tp_axis,
                          ep_axis=ep_axis, pp_axis=pp_axis, moe_aux_coef=moe_aux_coef,
                          model_kwargs=model_kwargs)

    def step(state: TrainState, images, labels, lr):
        dev = next(state.params.parameters()).device
        sums = body(state, _to(images, dev), _to(labels, dev), lr)
        metrics = metrics_from_sums(sums, len(labels), device_metrics)
        metrics["preempt"] = sums[3]
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step


def eval_sums(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[loss, top1, top5, count]`` of one batch, unreduced: the masked
    sums of the per-example cross-entropy and of the top-1/top-5 hits, and
    the mask's sum (1.0 for real examples, 0.0 for padding, whose labels
    must still index a class)."""
    nll = F.cross_entropy(logits, labels, reduction="none")
    maxk = min(5, logits.shape[-1])
    pred = torch.topk(logits.float(), maxk, dim=-1).indices
    hits = (pred == labels.long()[:, None]).float() * mask[:, None]
    return torch.stack([torch.sum(nll * mask), torch.sum(hits[:, :1]),
                        torch.sum(hits[:, :maxk]), torch.sum(mask)])


def make_eval_step(*, compute_dtype: torch.dtype = torch.float32, tp_axis=None, ep_axis=None,
                   pp_axis=None, axis=None):
    """Build ``eval_step(state, images, labels, mask) -> sums``: the
    masked sums ``loss`` (of the per-example cross-entropy), ``top1``,
    ``top5`` and ``count`` over every rank's batch (one all-reduce), as
    0-dim f32 tensors, so the caller divides once at the end. ``mask`` is
    1.0 for real examples, 0.0 for padding.

    Under ``tp_axis`` or ``pp_axis`` the ranks of a model group (of a pipe
    group) share a batch, so the sums are taken over ``axis`` (the ranks
    that share this rank's model index, as ``tpu_dist/train/step.py::
    make_eval_step``'s ``axis``; without it the model's ranks are the
    world, one data row, and nothing is summed); under ``ep_axis`` every
    rank holds its own examples and the sums go over every rank. The
    sharded model joins its groups itself; a pipelined one streams the
    batch in as many microbatches as it has stages."""
    shared = tp_axis is not None or pp_axis is not None

    def eval_step(state: TrainState, images, labels, mask):
        model = state.params
        dev = next(model.parameters()).device
        images, labels = _to(images, dev), _to(labels, dev)
        mask = _to(mask, dev, torch.float32)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                logits = model(images.to(compute_dtype))
                sums = eval_sums(logits, labels, mask)
                if not (shared and axis is None):
                    sums = collectives.all_reduce_(
                        sums, group=axis.group if shared else None, kind="eval")
                return dict(zip(("loss", "top1", "top5", "count"), sums))
        finally:
            model.train(was_training)

    return eval_step
