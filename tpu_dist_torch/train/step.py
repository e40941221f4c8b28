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
* ``grad_clip_norm`` clips the reduced gradients by their global norm.
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

The step is :func:`make_step_body` (the work on device tensors, ending in
the metrics all-reduce, with nothing read back to the host) inside
:func:`make_train_step` (placement, the metrics dict, the step counter).
The fused epoch (:mod:`tpu_dist_torch.train.epoch`) runs the same body in
a CUDA graph, built without the SIGTERM flag, whose host read a graph
would freeze.

Without a process group every collective is the identity (a world of one
process). The step updates the model, its BN statistics and its momentum
buffers in place (the JAX step's ``donate=True``) and returns a state with
``step + 1``. Options whose subsystem is not ported raise
:class:`NotPortedError`, which names the flag and the ROADMAP queue that
owns it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint

from tpu_dist_torch.comm import collectives
from tpu_dist_torch.nn import functional as F
from tpu_dist_torch.nn import layers
from tpu_dist_torch.resilience import preemption
from tpu_dist_torch.train.state import TrainState

GRAD_COMPRESSION_MODES = ("none", "bf16", "int8", "int8_ef")

# option -> what it needs and where in ROADMAP.md that is queued
WAITS_FOR = {
    "shard_weight_update": "Queue A 6 (ZeRO-1 weight-update sharding, beside parallel/fsdp.py)",
    "rs_ag_chunks": "Queue A 6 (the chunked ZeRO-1 reduce-scatter / all-gather)",
    "seq_axis": "Queue A 3 (sequence parallelism)",
    "tp_axis": "Queue A 6 (tensor parallelism, parallel/tensor.py)",
    "ep_axis": "Queue A 6 (expert parallelism, parallel/expert.py)",
    "pp_axis": "Queue A 6 (pipeline parallelism, parallel/pipeline.py)",
    "grad_compression": "Queue A 6 (compressed collectives, comm/quantize.py)",
    "device_metrics": "Queue A 6 (training-health telemetry, obs/device_stats.py)",
}


class NotPortedError(NotImplementedError):
    """An option whose subsystem is not ported yet: names the flag and the
    ROADMAP item it waits for (``WAITS_FOR[flag]`` unless ``queue`` is
    given), instead of being a silent no-op."""

    def __init__(self, flag: str, value, queue: Optional[str] = None):
        self.flag = flag
        self.queue = queue or WAITS_FOR[flag]
        super().__init__(
            f"{flag}={value!r} is not ported to tpu_dist_torch yet; it waits for "
            f"ROADMAP.md {self.queue}"
        )


def _refuse_unported(**options) -> None:
    defaults = {"shard_weight_update": False, "seq_axis": None, "tp_axis": None,
                "ep_axis": None, "pp_axis": None, "grad_compression": "none", "rs_ag_chunks": 1,
                "device_metrics": False}
    for flag, value in options.items():
        if value != defaults[flag]:
            raise NotPortedError(flag, value)


def _to(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device, dtype=dtype)


def _flat_all_reduce_mean(tensors, kind: str) -> list:
    """One all-reduce over the concatenation of ``tensors``, divided by the
    world size; returns contiguous views of the reduced buffer in their
    shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collectives.all_reduce_(flat, kind=kind).div_(collectives.world_size())
    return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


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
):
    """Build ``body(state, images, labels, lr) -> sums``: the step on
    tensors already on the model's device. Forward and backward over the K
    chunks, the BN-state average without SyncBN, the gradient reduce, the
    clip and the optimizer's in-place update; then ONE all-reduce of
    ``[loss, top-1 hits, top-5 hits]`` (f32, summed over the ranks), which
    it returns. With ``preempt_flag`` a 4th element carries this rank's
    SIGTERM flag as read on the host when the step is built; without it
    (a step captured in a CUDA graph, where that read would be frozen) the
    body reads nothing of the host's state and nothing back from the
    device, so a graph can hold it. ``lr`` must then be a device tensor (a
    float would be frozen into the graph too). ``remat`` recomputes each
    chunk's forward in its backward."""
    if pmean_fusion not in ("fused", "per_leaf"):
        raise ValueError(f"pmean_fusion={pmean_fusion!r}: expected 'fused' or 'per_leaf'")
    K = int(grad_accum_steps)
    if K < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")

    def reduce_grads(grads):
        """The DDP gradient reduce: the mean over the ranks, once a step.
        The result is contiguous (the fused SGD kernel needs it; cuDNN
        hands back channels-last weight gradients)."""
        if not collectives.active():
            return [g.contiguous() for g in grads]
        if pmean_fusion == "fused":
            return _flat_all_reduce_mean(grads, "grad")
        world = collectives.world_size()
        return [collectives.all_reduce_(g.contiguous(), kind="grad").div_(world)
                for g in grads]

    def clip_grads(grads):
        """Global-norm clip: scale = min(1, clip / max(norm, 1e-12))."""
        if grad_clip_norm <= 0.0:
            return grads
        sq = sum(torch.sum(torch.square(g)) for g in grads)
        scale = torch.clamp(grad_clip_norm / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0)
        return [g * scale for g in grads]

    def body(state: TrainState, images, labels, lr) -> torch.Tensor:
        model = state.params
        params = list(model.parameters())
        if images.shape[0] % K:
            raise ValueError(f"batch {images.shape[0]} does not split into {K} chunks")
        n = images.shape[0] // K
        # BatchNorm models take the SyncBN group; the ViT has none
        fwd_kw = {"group": collectives.sync_group(sync_bn)} if state.bn_state else {}
        model.train()

        def forward_loss(x, y):
            out = model(x.to(compute_dtype), **fwd_kw)
            return F.cross_entropy(out, y, label_smoothing=label_smoothing), out

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
        optimizer.update(clip_grads(reduce_grads(grads)), state.opt_state, params, lr)

        c1, c5 = F.topk_correct(torch.cat(logits).float(), labels, (1, 5))
        sums = [loss.float(), c1.float(), c5.float()]
        if preempt_flag:
            # a fill kernel carries the flag: no host-to-device copy
            sums.append(torch.full((), float(preemption.requested()), device=loss.device))
        return collectives.all_reduce_(torch.stack(sums), kind="metrics")

    return body


def metrics_from_sums(sums: torch.Tensor, batch: int) -> dict:
    """The step's metrics from ``body``'s all-reduced sums and the per-rank
    batch: ``loss`` the mean over the ranks, ``acc1``/``acc5`` in percent
    of the global batch (0-dim tensors)."""
    world = collectives.world_size()
    return {
        "loss": sums[0] / world,
        "acc1": sums[1] / (batch * world) * 100.0,
        "acc5": sums[2] / (batch * world) * 100.0,
    }


def make_train_step(
    optimizer,
    *,
    grad_accum_steps: int = 1,
    sync_bn: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    label_smoothing: float = 0.0,
    grad_clip_norm: float = 0.0,
    shard_weight_update: bool = False,
    seq_axis: Optional[str] = None,
    tp_axis: Optional[str] = None,
    ep_axis: Optional[str] = None,
    pp_axis: Optional[str] = None,
    remat: bool = False,
    grad_compression: str = "none",
    pmean_fusion: str = "fused",
    rs_ag_chunks: int = 1,
    device_metrics: bool = False,
):
    """Build ``step(state, images, labels, lr) -> (state, metrics)``.

    ``state.params`` is the model (``images [B, ...] -> logits``, this
    rank's share of the global batch); images and labels are tensors or
    arrays, moved to the model's device; ``lr`` is a float or a float32
    scalar tensor there."""
    if grad_compression not in GRAD_COMPRESSION_MODES:
        raise ValueError(
            f"grad_compression must be one of {GRAD_COMPRESSION_MODES}, got {grad_compression!r}"
        )
    if int(rs_ag_chunks) < 1:
        raise ValueError(f"rs_ag_chunks={rs_ag_chunks}: must be >= 1")
    _refuse_unported(
        shard_weight_update=shard_weight_update, seq_axis=seq_axis, tp_axis=tp_axis,
        ep_axis=ep_axis, pp_axis=pp_axis, grad_compression=grad_compression,
        rs_ag_chunks=int(rs_ag_chunks),
        device_metrics=device_metrics,
    )
    body = make_step_body(optimizer, grad_accum_steps=grad_accum_steps, sync_bn=sync_bn,
                          compute_dtype=compute_dtype, label_smoothing=label_smoothing,
                          grad_clip_norm=grad_clip_norm, pmean_fusion=pmean_fusion,
                          remat=remat)

    def step(state: TrainState, images, labels, lr):
        dev = next(state.params.parameters()).device
        sums = body(state, _to(images, dev), _to(labels, dev), lr)
        metrics = metrics_from_sums(sums, len(labels))
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


def make_eval_step(*, compute_dtype: torch.dtype = torch.float32):
    """Build ``eval_step(state, images, labels, mask) -> sums``: the
    masked sums ``loss`` (of the per-example cross-entropy), ``top1``,
    ``top5`` and ``count`` over every rank's batch (one all-reduce), as
    0-dim f32 tensors, so the caller divides once at the end. ``mask`` is
    1.0 for real examples, 0.0 for padding."""

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
                sums = collectives.all_reduce_(eval_sums(logits, labels, mask), kind="eval")
                return dict(zip(("loss", "top1", "top5", "count"), sums))
        finally:
            model.train(was_training)

    return eval_step
