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

Stochastic rounding (``key``) is the compressed gradient reduce's
(``train/step.py::quantized_pmean_flat``): ``floor(x/s + u)``, its draws
``u`` from a :class:`StreamKey`, a counter-based stream on the device.
"""

from __future__ import annotations

import torch

#: Elements per quantization scale (one f32 per 256 int8: ~1.6% of the bytes).
DEFAULT_CHUNK = 256

_QMAX = 127.0  # symmetric int8: [-127, 127], -128 unused
_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer finalizer (two multiply-xorshift rounds) of ``x`` in
    [0, 2^32): a Python int or an int64 tensor. No product leaves int64
    (2^32 times a 27-bit constant), so a tensor and an int give the same
    bits."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


class StreamKey:
    """A key of the stochastic-rounding stream: ``value`` is an int in
    [0, 2^32) or a 0-d int64 tensor (a step count on the device, which a
    CUDA graph reads at each replay). :meth:`fold` derives a key from it
    and some data (``jax.random.fold_in``'s role); :meth:`uniform` draws
    from it."""

    def __init__(self, value):
        self.value = value

    def fold(self, data) -> "StreamKey":
        """The key of ``(self, data)``: ``data`` an int or a 0-d integer tensor."""
        if isinstance(data, torch.Tensor):
            data = data.to(torch.int64)
        return StreamKey(_mix32((_mix32((data & _M32) ^ 0x9E3779B9) + self.value) & _M32))

    def uniform(self, shape, device) -> torch.Tensor:
        """f32 draws in [0, 1) of ``shape`` on ``device``, 24 bits each: the
        hash of each element's index under this key."""
        n = 1
        for d in shape:
            n *= int(d)
        k = self.value
        if isinstance(k, torch.Tensor):
            k = k.to(device=device, dtype=torch.int64)
        k2 = _mix32(k ^ 0x85EBCA6B)
        h = _mix32(_mix32(torch.arange(n, dtype=torch.int64, device=device) ^ k) ^ k2)
        return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24))).reshape(tuple(shape))


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
    """``(..., m)`` float -> ``(int8 (..., m), f32 scales (..., k))``.
    Without ``key``: rounding to nearest (half to even). With it:
    stochastic rounding, ``floor(v + u)``, where ``u`` is
    ``key.uniform(shape, device)`` of the zero-padded block shape
    ``(..., k, chunk)``, the shape JAX draws (a :class:`StreamKey`, or any
    object with ``fold`` and ``uniform`` that hands out given draws). All-zero
    chunks get scale 0."""
    blocks, k, m = _chunked(x.to(torch.float32), chunk)
    scales = blocks.abs().amax(dim=-1) / _QMAX
    pos = scales > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, scales, torch.ones_like(scales)),
                      torch.zeros_like(scales))
    v = blocks * inv[..., None]
    if key is None:
        q = torch.round(v)
    else:
        q = torch.floor(v + key.uniform(v.shape, v.device).to(torch.float32).reshape(v.shape))
    q = q.clamp_(-_QMAX, _QMAX).to(torch.int8)
    return q.reshape(q.shape[:-2] + (k * chunk,))[..., :m], scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, chunk: int = DEFAULT_CHUNK):
    """Inverse of :func:`quantize_int8`: ``(..., m) int8 + (..., k) f32 ->
    (..., m) f32`` (``m`` need not divide by ``chunk``)."""
    m = q.shape[-1]
    k = scales.shape[-1]
    per_elem = torch.repeat_interleave(scales, chunk, dim=-1)[..., : k * chunk][..., :m]
    return q.to(torch.float32) * per_elem


__all__ = ["DEFAULT_CHUNK", "StreamKey", "padded_len", "quantize_int8", "dequantize_int8"]
