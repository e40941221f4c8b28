"""Flash attention forward: a hand-written CUDA kernel and its plain twin.

Counterpart of ``tpu_dist/ops/flash_attention.py`` (the Pallas TPU
kernel ``_fwd_kernel`` behind ``_fwd``). :func:`flash_fwd` works on
``[BH, S, D]`` and returns ``(out, m, l)`` with the JAX ``_fwd``'s
meaning: ``m`` is the row max of the scaled, masked scores and ``l`` the
row sum of ``exp(s - m)``, both f32; ``out = acc / max(l, 1e-30)`` in
``out_dtype or q.dtype``; the scale is ``1/sqrt(D)``; the causal mask is
``q_pos >= k_pos``.

Dispatch is by where the tensors lie: CPU tensors go to
:func:`flash_fwd_reference` (one softmax over the full score matrix, f32
accumulation); CUDA tensors go to the kernel in
``csrc/flash_attention_fwd.cu`` or the call raises. There is no fallback
from one to the other. The backward kernels belong to the training
slice: a tensor that requires grad is refused.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tpu_dist_torch.ops import _build

NEG_INF = -1e30  # the TPU kernel's fill: keeps exp() NaN-free
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention_fwd")
        fn = lib.tpu_dist_flash_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.tpu_dist_flash_fwd


def flash_fwd_reference(q3, k3, v3, causal: bool = False,
                        out_dtype: Optional[torch.dtype] = None):
    """The plain PyTorch version of :func:`flash_fwd`: the whole [S, S]
    score matrix, one softmax, f32 throughout."""
    qf, kf, vf = (t.float() for t in (q3, k3, v3))
    scale = 1.0 / math.sqrt(q3.shape[-1])
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale        # [BH, Sq, Sk]
    s_q, s_k = s.shape[-2], s.shape[-1]
    mask = torch.ones(s_q, s_k, dtype=torch.bool, device=s.device)
    if causal:
        pos_q = torch.arange(s_q, device=s.device)[:, None]
        pos_k = torch.arange(s_k, device=s.device)[None, :]
        mask = pos_q >= pos_k
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    out = torch.matmul(p, vf) / torch.clamp(l, min=1e-30)[..., None]
    return out.to(out_dtype or q3.dtype), m, l


def _check(q3, k3, v3, out_dtype) -> None:
    if any(t.requires_grad for t in (q3, k3, v3)):
        raise NotImplementedError(
            "flash_fwd has no backward yet (the backward kernels come with "
            "the training slice); call it under torch.no_grad() or "
            "torch.inference_mode()"
        )
    if q3.dim() != 3 or k3.shape != q3.shape or v3.shape != q3.shape:
        raise ValueError(
            f"flash_fwd takes q, k, v of one shape [BH, S, D], got "
            f"{tuple(q3.shape)}, {tuple(k3.shape)}, {tuple(v3.shape)}"
        )
    if q3.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim D must be one of {HEAD_DIMS}, got {q3.shape[-1]}")
    if q3.dtype not in _DTYPE_CODES or k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise TypeError(
            f"flash_fwd takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q3.dtype}, {k3.dtype}, {v3.dtype}"
        )
    if out_dtype is not None and out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if not (q3.is_contiguous() and k3.is_contiguous() and v3.is_contiguous()):
        raise ValueError("flash_fwd takes contiguous q, k, v (the kernel's layout)")


def _launch(q3, k3, v3, causal, out_dtype):
    dev = q3.device
    if k3.device != dev or v3.device != dev:
        raise ValueError(f"q, k, v lie on {dev}, {k3.device}, {v3.device}")
    bh, s, d = q3.shape
    odt = out_dtype or q3.dtype
    out = torch.empty((bh, s, d), dtype=odt, device=dev)
    m = torch.empty((bh, s), dtype=torch.float32, device=dev)
    l = torch.empty((bh, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(),
            bh, s, d, _DTYPE_CODES[q3.dtype], _DTYPE_CODES[odt], int(bool(causal)),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    return out, m, l


def flash_fwd(q3, k3, v3, causal: bool = False,
              out_dtype: Optional[torch.dtype] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[BH, S, D] q, k, v -> (out [BH, S, D], m [BH, S], l [BH, S]).

    CPU tensors run :func:`flash_fwd_reference`; CUDA tensors launch the
    kernel (``flash_fwd.launches`` counts those launches) or raise."""
    _check(q3, k3, v3, out_dtype)
    if q3.device.type == "cuda":
        return _launch(q3, k3, v3, causal, out_dtype)
    if q3.device.type == "cpu" and k3.device.type == "cpu" and v3.device.type == "cpu":
        return flash_fwd_reference(q3, k3, v3, causal, out_dtype)
    raise ValueError(
        f"flash_fwd runs on CUDA (the kernel) or the CPU (its plain "
        f"version), got q, k, v on {q3.device}, {k3.device}, {v3.device}"
    )


flash_fwd.launches = 0


def flash_attention(q, k, v, *, causal: bool = False):
    """Attention on [B, S, H, D], drop-in for
    :func:`tpu_dist_torch.nn.attention.full_attention` (f32 softmax
    accumulation, output in ``q.dtype``)."""
    b, s, h, d = q.shape

    def to3(t):
        # reshape may keep a strided view (b == 1): copy to the kernel's layout
        return t.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()

    out3, _, _ = flash_fwd(to3(q), to3(k), to3(v), causal)
    return out3.reshape(b, h, s, d).permute(0, 2, 1, 3)
