"""Conv, BatchNorm (with cross-rank sync) and linear: the port's
counterpart of ``tpu_dist/nn/layers.py``.

Tensors are NCHW here (channels on dim 1) where the JAX package is NHWC;
a channels-last NCHW tensor has NHWC's memory layout, which is what the
card's convolutions want. Each weight is cast to the activation dtype
where it is used, as the JAX step casts its parameter tree, so f32 master
weights take f32 gradients.

:func:`bn_apply` follows ``tpu_dist/nn/layers.py::bn_apply`` formula for
formula (torch's running-stat semantics, JAX's sync):

* training statistics in f32 even under bf16 compute: ``mean`` and
  ``mean_sq`` over N, H, W;
* with a ``group``, ``mean`` and ``mean_sq`` are averaged over its ranks
  by a differentiable all-reduce (the backward carries the other ranks'
  terms, as JAX's transpose of ``pmean`` does), and ``n`` is the global
  count;
* ``var = max(mean_sq - mean², 0)``; the running-stat EMA (momentum 0.1)
  takes the unbiased ``var · n/(n-1)``, the normalisation the biased
  ``var``;
* ``(x - mean) · rsqrt(var + eps) · scale + bias`` in the activation
  dtype, scale and bias cast to it.

``torch.nn.SyncBatchNorm`` is not used: it refuses CPU tensors and
computes its statistics with another (Welford) formula.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from tpu_dist_torch.comm import collectives
from tpu_dist_torch.nn import initializers

BN_MOMENTUM = 0.1  # torch BatchNorm2d default
BN_EPS = 1e-5


def conv_apply(weight: torch.Tensor, x: torch.Tensor, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """Bias-free 2-D convolution, OIHW weight cast to ``x``'s dtype."""
    return F.conv2d(x, weight.to(x.dtype), stride=stride, padding=padding)


def _channel(t: torch.Tensor) -> torch.Tensor:
    return t[None, :, None, None]


def bn_apply(weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
             var: torch.Tensor, x: torch.Tensor, *, train: bool, group=None,
             momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
    """Returns ``(y, new_mean, new_var)``; the new running statistics are
    detached f32 tensors (the inputs in eval mode). ``group`` set →
    SyncBatchNorm over its ranks; None → this rank's statistics."""
    scale, shift = _channel(weight.to(x.dtype)), _channel(bias.to(x.dtype))
    if not train:
        inv = torch.rsqrt(_channel(var.to(x.dtype)) + eps)
        return (x - _channel(mean.to(x.dtype))) * inv * scale + shift, mean, var

    xf = x.float()
    dims = (0, 2, 3)  # all but the channel
    stats = torch.stack([xf.mean(dim=dims), xf.square().mean(dim=dims)])
    n = x.numel() // x.shape[1]
    if group is not None:
        world = collectives.world_size(group)
        stats = collectives.sum_across_ranks(stats, group=group, kind="bn") / world
        n *= world
    batch_mean, mean_sq = stats[0], stats[1]
    batch_var = torch.clamp(mean_sq - batch_mean.square(), min=0.0)

    with torch.no_grad():
        unbiased = batch_var * (n / max(n - 1, 1))
        new_mean = (1.0 - momentum) * mean + momentum * batch_mean
        new_var = (1.0 - momentum) * var + momentum * unbiased
    inv = torch.rsqrt(batch_var + eps).to(x.dtype)
    y = (x - _channel(batch_mean.to(x.dtype))) * _channel(inv) * scale + shift
    return y, new_mean, new_var


def linear_apply(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ W^T + b`` with an ``[out, in]`` weight in ``x``'s dtype."""
    return F.linear(x, weight.to(x.dtype), bias.to(x.dtype))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NC (AdaptiveAvgPool2d((1, 1)) + flatten)."""
    return x.mean(dim=(2, 3))


class BatchNorm(nn.Module):
    """BatchNorm2d with the running statistics as buffers, updated in place
    on every training forward (the JAX ``new_state``, read back through
    ``running_mean``/``running_var``), except inside
    :func:`running_stats_frozen`."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.update_running_stats = True

    def forward(self, x, *, train: bool, group=None):
        y, new_mean, new_var = bn_apply(self.weight, self.bias, self.running_mean,
                                        self.running_var, x, train=train, group=group)
        if train and self.update_running_stats:
            self.running_mean.copy_(new_mean)
            self.running_var.copy_(new_var)
        return y


@contextlib.contextmanager
def running_stats_frozen(model: nn.Module):
    """Inside, ``model``'s BatchNorm layers normalise as in training but
    leave their running statistics as they are: the forward that activation
    checkpointing runs again in the backward (``train/step.py``'s
    ``remat``) must not apply the EMA a second time. The SyncBN all-reduce
    of the statistics still runs, as JAX's recomputed ``pmean`` does."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in layers:
        m.update_running_stats = False
    try:
        yield
    finally:
        for m in layers:
            m.update_running_stats = True


def conv_module(in_ch: int, out_ch: int, ksize: int, gen: torch.Generator) -> nn.Conv2d:
    """A bias-free ``nn.Conv2d`` holding an OIHW weight drawn from ``gen``
    (Kaiming-uniform, fan_in = ksize²·in_ch); the global RNG is untouched."""
    conv = nn.Conv2d(in_ch, out_ch, ksize, bias=False, device="meta")
    conv.weight = nn.Parameter(
        initializers.kaiming_uniform(conv.weight.shape, ksize * ksize * in_ch, gen))
    return conv


def linear_module(in_dim: int, out_dim: int, gen: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with torch's default init drawn from ``gen``."""
    lin = nn.Linear(in_dim, out_dim, device="meta")
    lin.weight = nn.Parameter(initializers.kaiming_uniform(lin.weight.shape, in_dim, gen))
    lin.bias = nn.Parameter(initializers.uniform_fan_in(lin.bias.shape, in_dim, gen))
    return lin
