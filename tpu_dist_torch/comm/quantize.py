"""Per-chunk int8 quantization: the port's copy of
``tpu_dist/comm/quantize.py`` (``padded_len``, ``_chunked``,
``quantize_int8``, ``dequantize_int8``), in torch.

A vector is cut into ``chunk``-element blocks (zero-padded at its tail);
each block gets one f32 scale, ``max|x| / 127``, and its elements become
``round(x * (1 / scale))`` clipped to ``[-127, 127]``. The arithmetic
follows the JAX function step by step (the reciprocal first, then the
product; round half to even; an all-zero block gets scale 0 and zeros),
so the same f32 input gives the same int8 and the same scales bit for
bit. Serving quantizes its weights with it (``serve/engine.py``).

Stochastic rounding (``key``) belongs to the compressed collectives,
which are not ported: it raises rather than rounding to nearest quietly.
"""

from __future__ import annotations

import torch

#: Elements per quantization scale (one f32 per 256 int8: ~1.6% of the bytes).
DEFAULT_CHUNK = 256

_QMAX = 127.0  # symmetric int8: [-127, 127], -128 unused


def padded_len(length: int, n: int) -> int:
    """Smallest multiple of ``n`` that is >= ``length``: the ZeRO-1 flat
    layout's length at a data-parallel extent of ``n``."""
    return -(-int(length) // int(n)) * int(n)


def _chunked(x: torch.Tensor, chunk: int):
    """``(..., m)`` -> ``(..., k, chunk)`` with a zero tail; returns
    ``(blocks, k, m)``."""
    m = x.shape[-1]
    k = -(-m // chunk)
    pad = k * chunk - m
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(x.shape[:-1] + (k, chunk)), k, m


def quantize_int8(x: torch.Tensor, chunk: int = DEFAULT_CHUNK, key=None):
    """``(..., m)`` float -> ``(int8 (..., m), f32 scales (..., k))``,
    rounding to nearest (half to even). All-zero chunks get scale 0."""
    if key is not None:
        from tpu_dist_torch.train.step import NotPortedError  # noqa: PLC0415

        raise NotPortedError("key", key, "Queue A 6 (compressed collectives, comm/quantize.py): "
                             "stochastic rounding")
    blocks, k, m = _chunked(x.to(torch.float32), chunk)
    scales = blocks.abs().amax(dim=-1) / _QMAX
    pos = scales > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, scales, torch.ones_like(scales)),
                      torch.zeros_like(scales))
    q = torch.round(blocks * inv[..., None]).clamp_(-_QMAX, _QMAX).to(torch.int8)
    return q.reshape(q.shape[:-2] + (k * chunk,))[..., :m], scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, chunk: int = DEFAULT_CHUNK):
    """Inverse of :func:`quantize_int8`: ``(..., m) int8 + (..., k) f32 ->
    (..., m) f32`` (``m`` need not divide by ``chunk``)."""
    m = q.shape[-1]
    k = scales.shape[-1]
    per_elem = torch.repeat_interleave(scales, chunk, dim=-1)[..., : k * chunk][..., :m]
    return q.to(torch.float32) * per_elem


__all__ = ["DEFAULT_CHUNK", "padded_len", "quantize_int8", "dequantize_int8"]
