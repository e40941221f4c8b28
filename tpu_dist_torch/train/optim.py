"""The optimizers and the learning-rate schedules: the port's counterpart
of ``tpu_dist/train/optim.py`` (``SGD``, ``AdamW``, ``_trust_ratio``,
``LARS``, ``LAMB``, ``multistep_lr``, ``linear_scaled_lr``,
``cosine_lr``).

SGD's update is the JAX package's, per leaf in f32:

* weight decay is added to the gradient (L2, not decoupled): ``g' = g + wd·p``;
* momentum buffer ``b ← μ·b + g'`` (no dampening);
* update ``p ← p − lr·b``, or ``p ← p − lr·(g' + μ·b)`` with Nesterov.

AdamW, LARS and LAMB keep the JAX formulas operation for operation, not
``torch.optim``'s (which decays first, as ``p·(1 − lr·wd)``, and divides by
``sqrt(v)/sqrt(bc2)``: other roundings). Their rank ≤ 1 exclusions read the
leaf's rank, which is the JAX leaf's for every ResNet and ViT leaf
(``tests/test_torch_optim.py`` pins it).

Where the JAX optimizers return new pytrees, these update the parameters
and their state IN PLACE and return them. Nothing here reads a value back
to the host: AdamW's and LAMB's step ``count`` is a 0-d int32 tensor on the
parameters' device and the bias corrections are computed from it there, and
the trust ratios are device tensors, so a step captured in a CUDA graph
(``train/epoch.py``) replays with the current count, not the captured one.
XLA fuses these updates and the JAX package has no Pallas kernel for them:
here they are ``torch._foreach_*`` ops (AdamW, and LAMB's moments) and a loop
over the leaves (the per-leaf norms).

Under ZeRO-1 (``train/step.py``) the update runs on one flat shard: SGD's
as one leaf (through the fused kernel with ``fused=True``, as the JAX
``SGD.update`` hands the flat shard to ``fused_sgd_leaf``), AdamW's on
its flat state (:meth:`AdamW.init_flat_state`) with the decay mask as a
per-element vector built from :meth:`AdamW.leaf_wd_intervals`
(``update(wd_tree=)``). LARS and LAMB need per-layer norms, which the flat
layout loses: the trainer refuses them there. Under FSDP
(:mod:`tpu_dist_torch.parallel.fsdp`) every optimizer updates the shards,
LARS and LAMB with each leaf's norm summed over its shards
(``update(leaf_norms=)``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

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


def _moments(grads, opt_state, b1: float, b2: float):
    """The Adam moments of AdamW and LAMB, in place: ``count += 1``,
    ``mu ← b1·mu + (1 − b1)·g``, ``nu ← b2·nu + (1 − b2)·g²``. Returns the
    bias corrections ``(1 − b1^count, 1 − b2^count)`` as f32 device
    tensors."""
    mu, nu, count = opt_state["mu"], opt_state["nu"], opt_state["count"]
    count.add_(1)
    cf = count.float()
    bc1 = 1.0 - torch.pow(b1, cf)
    bc2 = 1.0 - torch.pow(b2, cf)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
    return bc1, bc2


def _adam_direction(opt_state, bc1, bc2, eps: float) -> List[torch.Tensor]:
    """``(mu/bc1) / (sqrt(nu/bc2) + eps)`` of every leaf (new tensors)."""
    den = torch._foreach_div(opt_state["nu"], bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    u = torch._foreach_div(opt_state["mu"], bc1)
    torch._foreach_div_(u, den)
    return u


def _adam_init(params) -> Dict[str, object]:
    """Zero f32 moments, one each per parameter, and a 0-d int32 step count
    on the parameters' device."""
    device = params[0].device if params else None
    return {"mu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "count": torch.zeros((), dtype=torch.int32, device=device)}


class AdamW:
    """Decoupled-weight-decay Adam (Loshchilov & Hutter), the JAX package's
    formula: ``p ← p − lr·((mu/bc1)/(sqrt(nu/bc2) + eps) + wd·p)``. State:
    ``{"mu": [...], "nu": [...], "count": 0-d int32}``, the JAX dict."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01, decay_mask: str = "auto"):
        """``decay_mask``: ``"auto"`` skips the decay on rank ≤ 1 leaves
        (biases, LayerNorm/BN scales, 1-D tables); ``"all"`` decays every
        leaf."""
        if decay_mask not in ("auto", "all"):
            raise ValueError(f"decay_mask must be 'auto' or 'all', got {decay_mask!r}")
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decay_mask = decay_mask

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, object]:
        return _adam_init(params)

    def init_flat_state(self, length: int, device=None) -> Dict[str, object]:
        """Fresh ZeRO-1 state: f32 ``mu`` and ``nu`` of ``length`` (a rank's
        shard of the padded raveled parameters) and the 0-d int32 count."""
        return {"mu": torch.zeros(length, dtype=torch.float32, device=device),
                "nu": torch.zeros(length, dtype=torch.float32, device=device),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def _leaf_wd(self, p: torch.Tensor) -> float:
        return self.weight_decay if self.decay_mask == "all" or p.dim() > 1 else 0.0

    def leaf_wd_intervals(self, params: Sequence[torch.Tensor]) -> List[Tuple[int, int, float]]:
        """The decay mask in flat coordinates: ``[start, end)`` ranges of the
        raveled parameters (in ``params``' order) that take weight decay,
        with their decay."""
        out, off = [], 0
        for p in params:
            w = self._leaf_wd(p)
            if w:
                out.append((off, off + p.numel(), float(w)))
            off += p.numel()
        return out

    def update(self, grads, opt_state, params, lr, wd_tree=None):
        """Apply one step in place; returns ``(params, opt_state)``. ``lr``
        is a float or a float32 scalar tensor. ``wd_tree`` overrides the
        per-leaf decay: one float or per-element tensor a leaf (the ZeRO-1
        flat shard passes its positional decay vector)."""
        with torch.no_grad():
            bc1, bc2 = _moments(grads, opt_state, self.b1, self.b2)
            u = _adam_direction(opt_state, bc1, bc2, self.eps)
            if wd_tree is None:
                wd = self.weight_decay
                decayed = [i for i, p in enumerate(params) if self._leaf_wd(p)]
                if decayed:
                    ud = [u[i] for i in decayed]
                    torch._foreach_add_(ud, torch._foreach_mul([params[i] for i in decayed], wd))
            else:
                for ui, p, w in zip(u, params, wd_tree):
                    ui.add_(w * p)
            torch._foreach_sub_(list(params), torch._foreach_mul(u, lr))
        return params, opt_state


def _trust_ratio(pn: torch.Tensor, un: torch.Tensor, eps: float) -> torch.Tensor:
    """``‖p‖/(‖u‖ + eps)`` from the two norms, shared by LARS and LAMB; 1.0
    when either is 0 (fresh zero leaves, dead gradients). A device
    tensor."""
    return torch.where((pn > 0.0) & (un > 0.0), pn / (un + eps), torch.ones_like(pn))


def _norms(tensors, leaf_norms) -> list:
    """The norm of each tensor's whole leaf: ``leaf_norms(tensors)`` when
    the leaves are sharded (FSDP's hook sums each leaf's squares over its
    group), else each rank > 1 tensor's own (None for the others)."""
    if leaf_norms is not None:
        return leaf_norms(list(tensors))
    return [torch.linalg.vector_norm(t) if t.dim() > 1 else None for t in tensors]


class LARS:
    """Layer-wise Adaptive Rate Scaling (You, Gitman & Ginsburg): SGD with
    momentum whose step on each leaf of rank > 1 is scaled by
    ``eta·‖p‖/(‖g‖ + wd·‖p‖ + eps)`` (1.0 when a norm is 0) and takes the
    weight decay; rank ≤ 1 leaves take neither. State: one momentum buffer
    per parameter, as SGD's."""

    def __init__(self, momentum: float = 0.9, weight_decay: float = 1e-4,
                 trust_coefficient: float = 1e-3, eps: float = 1e-9):
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trust_coefficient = trust_coefficient
        self.eps = eps

    def init(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.zeros_like(p, requires_grad=False) for p in params]

    def update(self, grads, opt_state, params, lr, leaf_norms=None):
        """Apply one step in place; returns ``(params, opt_state)``.
        ``leaf_norms`` gives each leaf's norm from its shards (FSDP)."""
        mu, wd, eta, eps = self.momentum, self.weight_decay, self.trust_coefficient, self.eps
        with torch.no_grad():
            pns, gns = _norms(params, leaf_norms), _norms(grads, leaf_norms)
            for p, g, b, pn, gn in zip(params, grads, opt_state, pns, gns):
                if p.dim() > 1:
                    local = torch.where((pn > 0.0) & (gn > 0.0),
                                        eta * pn / (gn + wd * pn + eps), torch.ones_like(pn))
                    b.copy_(b * mu + local * (g + wd * p))
                else:
                    b.copy_(b * mu + g)
                p.sub_(lr * b)
        return params, opt_state


class LAMB:
    """Layer-wise Adaptive Moments (You et al.): AdamW's bias-corrected
    direction ``u`` plus ``wd·p``, scaled on each leaf of rank > 1 by the
    trust ratio ``‖p‖/‖u‖`` (:func:`_trust_ratio`); rank ≤ 1 leaves take
    neither the decay nor the ratio. State: AdamW's dict."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, object]:
        return _adam_init(params)

    def update(self, grads, opt_state, params, lr, leaf_norms=None):
        """Apply one step in place; returns ``(params, opt_state)``.
        ``leaf_norms`` gives each leaf's norm from its shards (FSDP)."""
        with torch.no_grad():
            bc1, bc2 = _moments(grads, opt_state, self.b1, self.b2)
            u = _adam_direction(opt_state, bc1, bc2, self.eps)
            u = [ui + self.weight_decay * p if p.dim() > 1 else ui for p, ui in zip(params, u)]
            pns, uns = _norms(params, leaf_norms), _norms(u, leaf_norms)
            for p, ui, pn, un in zip(params, u, pns, uns):
                if p.dim() > 1:
                    p.sub_(lr * _trust_ratio(pn, un, self.eps) * ui)
                else:
                    p.sub_(lr * ui)
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
