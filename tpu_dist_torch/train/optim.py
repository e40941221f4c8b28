"""SGD + momentum + weight decay and the learning-rate schedules: the
port's counterpart of ``tpu_dist/train/optim.py`` (``SGD``,
``multistep_lr``, ``linear_scaled_lr``, ``cosine_lr``).

The update is the JAX package's, per leaf in f32:

* weight decay is added to the gradient (L2, not decoupled): ``g' = g + wd·p``;
* momentum buffer ``b ← μ·b + g'`` (no dampening);
* update ``p ← p − lr·b``, or ``p ← p − lr·(g' + μ·b)`` with Nesterov.

Where the JAX optimizer returns new pytrees, this one updates the
parameters and buffers IN PLACE and returns them. AdamW, LARS and LAMB
are not ported yet (ROADMAP Queue A 6).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from tpu_dist_torch.ops.fused_sgd import fused_sgd, fused_sgd_reference


class SGD:
    def __init__(
        self,
        momentum: float = 0.9,
        weight_decay: float = 1e-4,
        nesterov: bool = False,
        fused: bool = False,
    ):
        """``fused=True`` sends the whole update through one launch of the
        CUDA kernel (:func:`tpu_dist_torch.ops.fused_sgd.fused_sgd`) for
        CUDA leaves, and through its plain version for CPU leaves; it
        agrees bit for bit with the plain update."""
        if fused and nesterov:
            raise ValueError("fused SGD does not implement nesterov")
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.fused = fused

    def init(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Zero momentum buffers, one per parameter, in parameter order."""
        return [torch.zeros_like(p, requires_grad=False) for p in params]

    def update(self, grads, opt_state, params, lr) -> Tuple[list, list]:
        """Apply one step in place; returns ``(params, opt_state)``. ``lr``
        is a float or a float32 scalar tensor."""
        mu, wd = self.momentum, self.weight_decay
        if self.fused:
            fused_sgd(params, grads, opt_state, lr, momentum=mu, weight_decay=wd)
        elif not self.nesterov:
            # the same six roundings as the fused kernel: one definition
            fused_sgd_reference(params, grads, opt_state, lr, momentum=mu, weight_decay=wd)
        else:
            with torch.no_grad():
                for p, g, b in zip(params, grads, opt_state):
                    g2 = g + p * wd
                    b.copy_(b * mu + g2)
                    p.copy_(p - (g2 + b * mu) * lr)
        return params, opt_state


def multistep_lr(
    base_lr: float,
    milestones: Sequence[int] = (60, 120, 160),
    gamma: float = 0.2,
    warmup_epochs: int = 0,
):
    """``lr(epoch)``: ``base_lr · γ^(#milestones ≤ epoch)``, after an
    optional linear warmup of ``warmup_epochs`` to ``base_lr``."""
    ms: Tuple[int, ...] = tuple(sorted(milestones))

    def schedule(epoch: int) -> float:
        if warmup_epochs > 0 and epoch < warmup_epochs:
            return float(base_lr * (epoch + 1) / warmup_epochs)
        k = sum(1 for m in ms if epoch >= m)
        return float(base_lr * (gamma ** k))

    return schedule


def linear_scaled_lr(base_lr: float, base_batch: int, global_batch: int) -> float:
    """The linear-scaling rule ``lr = base_lr · B/B₀`` (Goyal et al.)."""
    if base_batch <= 0:
        raise ValueError(f"base_batch must be positive, got {base_batch}")
    if global_batch <= 0:
        raise ValueError(f"global_batch must be positive, got {global_batch}")
    return float(base_lr * global_batch / base_batch)


def cosine_lr(base_lr: float, total_epochs: int, warmup_epochs: int = 0, min_lr: float = 0.0):
    """Linear warmup, then cosine decay to ``min_lr``; epoch-granular."""
    def schedule(epoch: int) -> float:
        if warmup_epochs > 0 and epoch < warmup_epochs:
            return float(base_lr * (epoch + 1) / warmup_epochs)
        t = (epoch - warmup_epochs) / max(1, total_epochs - warmup_epochs)
        t = min(max(t, 0.0), 1.0)
        return float(min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * t)))

    return schedule
