"""The train and eval steps on one device: the port's counterpart of
``tpu_dist/train/step.py`` (``make_train_step``, ``make_eval_step``) with
every collective over a one-device mesh taken out.

* The loss casts the images to ``compute_dtype``; the model casts each
  weight to the activation dtype where it uses it (``nn/vit.py``), exactly
  where the JAX step casts the parameter tree, so f32 master weights take
  f32 gradients. There is no autocast and no loss scaling.
* Gradient accumulation over ``grad_accum_steps`` K chunks sums the K
  chunk gradients and divides by K; the loss is the mean of the K chunk
  losses, and the metrics read all chunks' logits.
* ``grad_clip_norm`` clips by the global norm of all gradients.
* Metrics are 0-dim tensors on the device (no host sync): ``loss``, and
  ``acc1``/``acc5`` in percent.

The step updates the model and its momentum buffers in place (the JAX
step's ``donate=True``) and returns a state with ``step + 1``. Options
whose subsystem is not ported raise :class:`NotPortedError`, which names
the flag and the ROADMAP queue that owns it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_dist_torch.nn import functional as F
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
    "remat": "Queue A 6 (activation rematerialization)",
    "grad_compression": "Queue A 6 (compressed collectives, comm/quantize.py)",
    "pmean_fusion": "Queue A 2 (the DDP gradient all-reduce over NCCL)",
    "device_metrics": "Queue A 6 (training-health telemetry, obs/device_stats.py)",
}


class NotPortedError(NotImplementedError):
    """A step option whose subsystem is not ported yet: names the flag and
    the ROADMAP queue it waits for, instead of being a silent no-op."""

    def __init__(self, flag: str, value):
        self.flag = flag
        self.queue = WAITS_FOR[flag]
        super().__init__(
            f"{flag}={value!r} is not ported to tpu_dist_torch yet; it waits for "
            f"ROADMAP.md {self.queue}"
        )


def _refuse_unported(**options) -> None:
    defaults = {"shard_weight_update": False, "seq_axis": None, "tp_axis": None,
                "ep_axis": None, "pp_axis": None, "remat": False,
                "grad_compression": "none", "pmean_fusion": "fused",
                "rs_ag_chunks": 1, "device_metrics": False}
    for flag, value in options.items():
        if value != defaults[flag]:
            raise NotPortedError(flag, value)


def _to(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device, dtype=dtype)


def make_train_step(
    optimizer,
    *,
    grad_accum_steps: int = 1,
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

    ``state.params`` is the model (``images [B, ...] -> logits``); images
    and labels are tensors or arrays, moved to the model's device; ``lr``
    is a float or a float32 scalar tensor there."""
    if grad_compression not in GRAD_COMPRESSION_MODES:
        raise ValueError(
            f"grad_compression must be one of {GRAD_COMPRESSION_MODES}, got {grad_compression!r}"
        )
    if pmean_fusion not in ("fused", "per_leaf"):
        raise ValueError(f"pmean_fusion={pmean_fusion!r}: expected 'fused' or 'per_leaf'")
    if int(rs_ag_chunks) < 1:
        raise ValueError(f"rs_ag_chunks={rs_ag_chunks}: must be >= 1")
    _refuse_unported(
        shard_weight_update=shard_weight_update, seq_axis=seq_axis, tp_axis=tp_axis,
        ep_axis=ep_axis, pp_axis=pp_axis, remat=remat, grad_compression=grad_compression,
        pmean_fusion=pmean_fusion, rs_ag_chunks=int(rs_ag_chunks),
        device_metrics=device_metrics,
    )
    K = int(grad_accum_steps)
    if K < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")

    def clip_grads(grads):
        """Global-norm clip: scale = min(1, clip / max(norm, 1e-12))."""
        if grad_clip_norm <= 0.0:
            return grads
        sq = sum(torch.sum(torch.square(g)) for g in grads)
        scale = torch.clamp(grad_clip_norm / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0)
        return [g * scale for g in grads]

    def step(state: TrainState, images, labels, lr):
        model = state.params
        params = list(model.parameters())
        dev = params[0].device
        images, labels = _to(images, dev), _to(labels, dev)
        if images.shape[0] % K:
            raise ValueError(f"batch {images.shape[0]} does not split into {K} chunks")
        n = images.shape[0] // K
        model.train()
        grads, losses, logits = None, [], []
        for c in range(K):
            with torch.enable_grad():
                out = model(images[c * n:(c + 1) * n].to(compute_dtype))
                loss = F.cross_entropy(out, labels[c * n:(c + 1) * n],
                                       label_smoothing=label_smoothing)
                g = torch.autograd.grad(loss, params)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            losses.append(loss.detach())
            logits.append(out.detach())
        if K > 1:
            grads = [g / K for g in grads]
        loss = torch.stack(losses).mean() if K > 1 else losses[0]
        optimizer.update(clip_grads(grads), state.opt_state, params, lr)

        c1, c5 = F.topk_correct(torch.cat(logits).float(), labels, (1, 5))
        b = labels.shape[0]
        metrics = {
            "loss": loss,
            "acc1": c1.float() / b * 100.0,
            "acc5": c5.float() / b * 100.0,
        }
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step


def make_eval_step(*, compute_dtype: torch.dtype = torch.float32):
    """Build ``eval_step(state, images, labels, mask) -> sums``: the
    masked sums ``loss`` (of the per-example cross-entropy), ``top1``,
    ``top5`` and ``count``, as 0-dim f32 tensors, so the caller divides
    once at the end. ``mask`` is 1.0 for real examples, 0.0 for padding."""

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
                nll = F.cross_entropy(logits, labels, reduction="none")
                maxk = min(5, logits.shape[-1])
                pred = torch.topk(logits.float(), maxk, dim=-1).indices
                hits = (pred == labels.long()[:, None]).float() * mask[:, None]
                return {
                    "loss": torch.sum(nll * mask),
                    "top1": torch.sum(hits[:, :1]),
                    "top5": torch.sum(hits[:, :maxk]),
                    "count": torch.sum(mask),
                }
        finally:
            model.train(was_training)

    return eval_step
