"""Loss and classification functionals: the port's counterpart of
``tpu_dist/nn/functional.py`` (``cross_entropy``, ``topk_correct``,
``accuracy``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

REDUCTIONS = ("mean", "sum", "none")


def cross_entropy(logits, labels, *, reduction: str = "mean",
                  label_smoothing: float = 0.0):
    """Softmax cross-entropy with integer labels (optionally smoothed),
    computed in f32 whatever the logits' dtype. ``label_smoothing=s``
    mixes the one-hot target with the uniform distribution (torch
    semantics): ``(1 - s) * nll + s * mean(-log p)``."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"reduction must be one of {REDUCTIONS}, got {reduction!r}")
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if label_smoothing > 0.0:
        s = label_smoothing
        uniform = -logp.mean(dim=-1)
        nll = (1.0 - s) * nll + s * uniform
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def topk_correct(logits, labels, ks: Sequence[int] = (1, 5)) -> Tuple[torch.Tensor, ...]:
    """Per-batch counts of top-k hits (counts, not percentages, so shards
    sum exactly); ``k`` is clamped to the number of classes."""
    maxk = min(max(ks), logits.shape[-1])
    pred = torch.topk(logits, maxk, dim=-1).indices            # [B, maxk]
    hits = pred == labels.long()[:, None]
    return tuple(hits[:, : min(k, maxk)].sum() for k in ks)


def accuracy(logits, labels, topk: Sequence[int] = (1,)) -> Tuple[torch.Tensor, ...]:
    """Percentages, the reference's ``accuracy(output, target, topk)``."""
    b = logits.shape[0]
    return tuple(c.float() * (100.0 / b) for c in topk_correct(logits, labels, topk))
