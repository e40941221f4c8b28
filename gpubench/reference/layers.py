"""The layers of the reference models, in float32 (or with the control's
fp8 rounding of every product's operands and every activation,
:func:`rounded`; ``"fp8_operands"`` rounds the operands alone)."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "bf16", "fp8", "fp8_operands")
_FORMATS = {  # dtype and its largest finite value
    "e4m3": (torch.float8_e4m3fn, 448.0),
    "e5m2": (torch.float8_e5m2, 57344.0),
}


def _round(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` rounded to the fp8 format ``fmt`` under a per-tensor scale
    that maps its largest magnitude to the format's largest value."""
    dtype, top = _FORMATS[fmt]
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Forward operands in e4m3, their gradients in e5m2 (the usual fp8
    training recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return _round(g, "e5m2")


class _Bf16(torch.autograd.Function):
    """Forward operands and their gradients rounded to bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as an activation in ``precision``."""
    if precision in ("f32", "fp8_operands"):
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    if precision == "bf16":
        return _Bf16.apply(x)
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product's operand in ``precision``."""
    return rounded(x, "fp8" if precision == "fp8_operands" else precision)


@contextlib.contextmanager
def full_float32():
    """float32 products with TF32 off, for cuBLAS and cuDNN alike."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def linear(x, w, b, precision: str):
    """``x @ w.T + b`` (``w`` is ``[out, in]``), its output an activation
    of ``precision`` as its operands are."""
    return rounded(F.linear(operand(x, precision), operand(w, precision), b), precision)


def conv2d(x, w, stride: int, padding: int, precision: str):
    """A bias-free convolution of NCHW ``x`` by an OIHW ``w``."""
    out = F.conv2d(operand(x, precision), operand(w, precision), stride=stride, padding=padding)
    return rounded(out, precision)


def layer_norm(x, w, b, eps: float, precision: str):
    """LayerNorm over the last dimension, computed in float32, its output
    an activation of ``precision``."""
    return rounded(F.layer_norm(x, (x.shape[-1],), w, b, eps), precision)


def gelu_tanh(x):
    """GELU, the tanh approximation (``jax.nn.gelu``'s default)."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def batch_norm_train(x, w, b, eps: float, precision: str):
    """The JAX package's training BatchNorm (``tpu_dist/nn/layers.py::
    bn_apply``), copied: the batch's ``mean`` and ``mean_sq`` over N, H,
    W in float32; ``var = max(mean_sq - mean², 0)``; ``(x - mean) ·
    rsqrt(var + eps) · w + b``, an activation of ``precision``."""
    dims = (0, 2, 3)
    mean = x.mean(dim=dims)
    var = torch.clamp(x.square().mean(dim=dims) - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps)
    y = (x - mean[None, :, None, None]) * inv[None, :, None, None] * w[None, :, None, None] \
        + b[None, :, None, None]
    return rounded(y, precision)


def cross_entropy_sum(logits, labels):
    """The summed softmax cross-entropy of integer labels."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).sum()
