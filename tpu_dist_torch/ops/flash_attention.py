"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain twins.

Counterpart of ``tpu_dist/ops/flash_attention.py``: :func:`flash_fwd`
replaces the Pallas kernel ``_fwd_kernel`` behind ``_fwd``;
:func:`flash_bwd_dkdv` and :func:`flash_bwd_dq` replace ``_bwd_dkdv_kernel``
and ``_bwd_dq_kernel`` behind ``_bwd_pallas`` (the FlashAttention-2
backward, P and dS recomputed from the saved ``m`` and ``l``);
:func:`flash_bwd` is ``_bwd_pallas`` and :func:`flash_attention` the
``_flash`` ``custom_vjp``, here a :class:`torch.autograd.Function`.

:func:`flash_fwd` works on ``[BH, S, D]`` and returns ``(out, m, l)`` with
the JAX ``_fwd``'s meaning: ``m`` is the row max of the scaled, masked
scores and ``l`` the row sum of ``exp(s - m)``, both f32; ``out = acc /
max(l, 1e-30)`` in ``out_dtype or q.dtype``; the scale is ``1/sqrt(D)``;
the causal mask is ``q_pos >= k_pos``. :func:`flash_bwd` returns ``(dq,
dk, dv)`` in ``grad_dtype`` or each input's dtype; ``delta =
rowsum(do * o)`` is plain PyTorch, as the JAX package leaves it to XLA,
and may be passed in precomputed.

Dispatch is by where the tensors lie: CPU tensors go to the plain versions
(``*_reference``: whole score matrices, f32 accumulation); CUDA tensors go
to the kernels in ``csrc/`` or the call raises. There is no fallback from
one to the other. On the card every kernel has two routes, by the input
dtype (:func:`uses_tensor_cores`, the rule of the C dispatch): bf16 inputs
run on the bf16 tensor cores, where the probabilities ``P`` (forward,
dK/dV) and the score gradients ``dS`` (dK/dV, dQ) enter their products as
bf16, so the plain versions round them there too for bf16 inputs; f32
inputs keep f32-accurate kernels, and their plain versions round nothing.
The kernel wrappers are not differentiable themselves: with grad enabled
they refuse a tensor that requires grad, and :func:`flash_attention` is
the differentiable entry point.

:func:`ring_flash_attention` is ``_ring_flash`` (``ring_flash_attention``
of the JAX package): the three kernels composed around a K/V ring over a
seq group, for sequence parallelism (the section at the end of this
module). It has no kernel of its own.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from tpu_dist_torch.comm import collectives
from tpu_dist_torch.obs import costmodel
from tpu_dist_torch.ops import _build

NEG_INF = -1e30  # the TPU kernel's fill: keeps exp() NaN-free
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CP_ASYNC_ALIGN = 16  # bytes a cp.async moves: the tensor-core kernels' operand alignment

_P = ctypes.c_void_p
_I = ctypes.c_int
# csrc source -> (exported function, its argument types)
_SIGNATURES = {
    "flash_attention_fwd": ("tpu_dist_flash_fwd", [_P] * 6 + [_I] * 6 + [_P]),
    "flash_attention_bwd_dkdv": ("tpu_dist_flash_bwd_dkdv", [_P] * 9 + [_I] * 6 + [_P]),
    "flash_attention_bwd_dq": ("tpu_dist_flash_bwd_dq", [_P] * 8 + [_I] * 6 + [_P]),
}


def _call(source: str, device: torch.device, *args) -> None:
    """Launch on the current stream of ``device``; raise on a refused launch."""
    fn = _build.bind(source, *_SIGNATURES[source])
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {err}")


def uses_tensor_cores(dtype: torch.dtype) -> bool:
    """Whether inputs of ``dtype`` take the bf16 tensor-core route of the
    forward, dK/dV and dQ kernels: bf16 does, f32 keeps the f32-accurate
    kernels (the rule of csrc/flash_attention_mma.cuh::tensor_core_route)."""
    return dtype == torch.bfloat16


def _round_like_tensor_cores(x: torch.Tensor, in_dtype: torch.dtype) -> torch.Tensor:
    """``x`` (f32) as the tensor-core kernels take it into a product: rounded
    to bf16 (to nearest even) for bf16 inputs, unchanged otherwise."""
    return x.to(torch.bfloat16).float() if uses_tensor_cores(in_dtype) else x


def _check_aligned(name: str, *tensors) -> None:
    """cp.async copies 16 bytes at a time: refuse a base pointer that is not
    16-byte aligned (a view that starts inside a tensor can be)."""
    for t in tensors:
        if t.data_ptr() % CP_ASYNC_ALIGN:
            raise ValueError(
                f"{name} takes tensors whose data starts {CP_ASYNC_ALIGN}-byte aligned "
                f"(the kernels' cp.async); got an address {t.data_ptr() % CP_ASYNC_ALIGN} "
                "bytes past it: pass a fresh .clone()"
            )


def _count_launch(wrapper, dtype: torch.dtype) -> None:
    wrapper.launches += 1
    # tpu-dist: ignore[TD001] — a host flag of the dtype, no tensor
    wrapper.launches_mma += int(uses_tensor_cores(dtype))


def _refuse_autograd(name: str, *tensors) -> None:
    """The kernel wrappers build no autograd graph: with grad enabled, a
    tensor that requires grad would come back silently detached."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is not differentiable; use flash_attention (the autograd "
            "function over the forward and backward kernels), or call it under "
            "torch.no_grad()"
        )


def _placement(name: str, *tensors) -> str:
    """'cuda' (the kernel) when every tensor lies on one CUDA device, 'cpu'
    (the plain version) when every one lies on the CPU; raises otherwise."""
    dev = tensors[0].device
    if dev.type in ("cuda", "cpu") and all(t.device == dev for t in tensors):
        return dev.type
    raise ValueError(
        f"{name} runs on CUDA (the kernel) or the CPU (its plain version), with "
        f"every tensor on one device; got {[str(t.device) for t in tensors]}"
    )


# -- forward -------------------------------------------------------------------


def _score_mask(s_q: int, s_k: int, causal: bool, device) -> torch.Tensor:
    if not causal:
        return torch.ones(s_q, s_k, dtype=torch.bool, device=device)
    pos_q = torch.arange(s_q, device=device)[:, None]
    pos_k = torch.arange(s_k, device=device)[None, :]
    return pos_q >= pos_k


def flash_fwd_reference(q3, k3, v3, causal: bool = False,
                        out_dtype: Optional[torch.dtype] = None):
    """The plain PyTorch version of :func:`flash_fwd`: the whole [S, S]
    score matrix, one softmax, f32 throughout; for bf16 inputs P enters
    P V rounded to bf16, as on the tensor cores (l sums the f32 P)."""
    qf, kf, vf = (t.float() for t in (q3, k3, v3))
    scale = 1.0 / math.sqrt(q3.shape[-1])
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale        # [BH, Sq, Sk]
    mask = _score_mask(s.shape[-2], s.shape[-1], causal, s.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    pv = torch.matmul(_round_like_tensor_cores(p, q3.dtype), vf)
    out = pv / torch.clamp(l, min=1e-30)[..., None]
    return out.to(out_dtype or q3.dtype), m, l


def _check_qkv(name: str, q3, k3, v3) -> None:
    if q3.dim() != 3 or k3.shape != q3.shape or v3.shape != q3.shape:
        raise ValueError(
            f"{name} takes q, k, v of one shape [BH, S, D], got "
            f"{tuple(q3.shape)}, {tuple(k3.shape)}, {tuple(v3.shape)}"
        )
    if q3.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim D must be one of {HEAD_DIMS}, got {q3.shape[-1]}")
    if q3.dtype not in _DTYPE_CODES or k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise TypeError(
            f"{name} takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q3.dtype}, {k3.dtype}, {v3.dtype}"
        )
    if not (q3.is_contiguous() and k3.is_contiguous() and v3.is_contiguous()):
        raise ValueError(f"{name} takes contiguous q, k, v (the kernel's layout)")


def _check_dtype_override(what: str, dtype) -> None:
    if dtype is not None and dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} must be float32 or bfloat16, got {dtype}")


def flash_fwd(q3, k3, v3, causal: bool = False,
              out_dtype: Optional[torch.dtype] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[BH, S, D] q, k, v -> (out [BH, S, D], m [BH, S], l [BH, S]).

    CPU tensors run :func:`flash_fwd_reference`; CUDA tensors launch the
    kernel or raise. ``flash_fwd.launches`` counts the launches and
    ``flash_fwd.launches_mma`` those of the tensor-core route."""
    _refuse_autograd("flash_fwd", q3, k3, v3)
    _check_qkv("flash_fwd", q3, k3, v3)
    _check_dtype_override("out_dtype", out_dtype)
    if _placement("flash_fwd", q3, k3, v3) == "cpu":
        return flash_fwd_reference(q3, k3, v3, causal, out_dtype)
    _check_aligned("flash_fwd", q3, k3, v3)
    bh, s, d = q3.shape
    odt = out_dtype or q3.dtype
    out = torch.empty((bh, s, d), dtype=odt, device=q3.device)
    m = torch.empty((bh, s), dtype=torch.float32, device=q3.device)
    l = torch.empty((bh, s), dtype=torch.float32, device=q3.device)
    _call("flash_attention_fwd", q3.device,
          q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
          out.data_ptr(), m.data_ptr(), l.data_ptr(),
          # tpu-dist: ignore[TD001] — host arguments of the launch, no tensor
          bh, s, d, _DTYPE_CODES[q3.dtype], _DTYPE_CODES[odt], int(bool(causal)))
    _count_launch(flash_fwd, q3.dtype)
    return out, m, l


flash_fwd.launches = 0
flash_fwd.launches_mma = 0


# -- backward ------------------------------------------------------------------


def _delta(do3, o3) -> torch.Tensor:
    """rowsum(do * o) in f32, [BH, S] (plain, as ``_bwd_pallas`` has it)."""
    return (do3.float() * o3.float()).sum(dim=-1)


def _p_ds_reference(q3, k3, v3, do3, m, l, delta, causal):
    """The plain ``_recompute_p_ds`` over whole rows: f32 ``(q, k, do, p, ds)``
    with p = exp(s - m) / max(l, 1e-30) (exact zeros where masked) and
    ds = p * (do v^T - delta) * scale."""
    qf, kf, vf, dof = (t.float() for t in (q3, k3, v3, do3))
    scale = 1.0 / math.sqrt(q3.shape[-1])
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale        # [BH, Sq, Sk]
    mask = _score_mask(s.shape[-2], s.shape[-1], causal, s.device)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    p = p / torch.clamp(l, min=1e-30)[..., None]
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return qf, kf, dof, p, ds


def flash_bwd_dkdv_reference(q3, k3, v3, do3, m, l, delta, causal: bool = False,
                             grad_dtype: Optional[torch.dtype] = None):
    """The plain version of :func:`flash_bwd_dkdv`: dV = P^T dO, dK = dS^T Q;
    for bf16 inputs P and dS enter the two products rounded to bf16, as on
    the tensor cores."""
    qf, _, dof, p, ds = _p_ds_reference(q3, k3, v3, do3, m, l, delta, causal)
    p, ds = (_round_like_tensor_cores(t, q3.dtype) for t in (p, ds))
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dk.to(grad_dtype or k3.dtype), dv.to(grad_dtype or v3.dtype)


def flash_bwd_dq_reference(q3, k3, v3, do3, m, l, delta, causal: bool = False,
                           grad_dtype: Optional[torch.dtype] = None):
    """The plain version of :func:`flash_bwd_dq`: dQ = dS K; for bf16 inputs
    dS enters the product rounded to bf16, as on the tensor cores."""
    _, kf, _, _, ds = _p_ds_reference(q3, k3, v3, do3, m, l, delta, causal)
    return torch.matmul(_round_like_tensor_cores(ds, q3.dtype), kf).to(grad_dtype or q3.dtype)


def flash_bwd_reference(q3, k3, v3, o3, m, l, do3, causal: bool = False, *,
                        delta: Optional[torch.Tensor] = None,
                        grad_dtype: Optional[torch.dtype] = None):
    """The plain version of :func:`flash_bwd` (the ``_bwd_blocked`` math
    over whole rows): ``(dq, dk, dv)``."""
    if delta is None:
        delta = _delta(do3, o3)
    dk, dv = flash_bwd_dkdv_reference(q3, k3, v3, do3, m, l, delta, causal, grad_dtype)
    dq = flash_bwd_dq_reference(q3, k3, v3, do3, m, l, delta, causal, grad_dtype)
    return dq, dk, dv


def _check_bwd(name: str, q3, k3, v3, do3, m, l, delta, grad_dtype) -> None:
    _check_qkv(name, q3, k3, v3)
    if do3.shape != q3.shape or do3.dtype != q3.dtype:
        raise TypeError(
            f"{name} takes do of q's shape and dtype {tuple(q3.shape)} {q3.dtype}, "
            f"got {tuple(do3.shape)} {do3.dtype}"
        )
    for what, t in (("m", m), ("l", l), ("delta", delta)):
        if t.shape != q3.shape[:2] or t.dtype != torch.float32:
            raise TypeError(
                f"{name} takes float32 {what} of shape {tuple(q3.shape[:2])}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if not all(t.is_contiguous() for t in (do3, m, l, delta)):
        raise ValueError(f"{name} takes contiguous do, m, l, delta (the kernel's layout)")
    _check_dtype_override("grad_dtype", grad_dtype)


def flash_bwd_dkdv(q3, k3, v3, do3, m, l, delta, causal: bool = False,
                   grad_dtype: Optional[torch.dtype] = None):
    """The dK/dV pass: ``(dk, dv)`` [BH, S, D] in ``grad_dtype`` or the
    inputs' dtype. CPU tensors run :func:`flash_bwd_dkdv_reference`; CUDA
    tensors launch ``csrc/flash_attention_bwd_dkdv.cu`` or raise
    (``flash_bwd_dkdv.launches`` counts the launches,
    ``flash_bwd_dkdv.launches_mma`` those of the tensor-core route)."""
    _refuse_autograd("flash_bwd_dkdv", q3, k3, v3, do3)
    _check_bwd("flash_bwd_dkdv", q3, k3, v3, do3, m, l, delta, grad_dtype)
    if _placement("flash_bwd_dkdv", q3, k3, v3, do3, m, l, delta) == "cpu":
        return flash_bwd_dkdv_reference(q3, k3, v3, do3, m, l, delta, causal, grad_dtype)
    _check_aligned("flash_bwd_dkdv", q3, k3, v3, do3)
    odt = grad_dtype or q3.dtype
    dk = torch.empty(q3.shape, dtype=odt, device=q3.device)
    dv = torch.empty(q3.shape, dtype=odt, device=q3.device)
    bh, s, d = q3.shape
    _call("flash_attention_bwd_dkdv", q3.device,
          q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
          m.data_ptr(), l.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          # tpu-dist: ignore[TD001] — host arguments of the launch, no tensor
          bh, s, d, _DTYPE_CODES[q3.dtype], _DTYPE_CODES[odt], int(bool(causal)))
    _count_launch(flash_bwd_dkdv, q3.dtype)
    return dk, dv


flash_bwd_dkdv.launches = 0
flash_bwd_dkdv.launches_mma = 0


def flash_bwd_dq(q3, k3, v3, do3, m, l, delta, causal: bool = False,
                 grad_dtype: Optional[torch.dtype] = None):
    """The dQ pass: ``dq`` [BH, S, D] in ``grad_dtype`` or q's dtype. CPU
    tensors run :func:`flash_bwd_dq_reference`; CUDA tensors launch
    ``csrc/flash_attention_bwd_dq.cu`` or raise (``flash_bwd_dq.launches``
    counts the launches, ``flash_bwd_dq.launches_mma`` those of the
    tensor-core route)."""
    _refuse_autograd("flash_bwd_dq", q3, k3, v3, do3)
    _check_bwd("flash_bwd_dq", q3, k3, v3, do3, m, l, delta, grad_dtype)
    if _placement("flash_bwd_dq", q3, k3, v3, do3, m, l, delta) == "cpu":
        return flash_bwd_dq_reference(q3, k3, v3, do3, m, l, delta, causal, grad_dtype)
    _check_aligned("flash_bwd_dq", q3, k3, v3, do3)
    odt = grad_dtype or q3.dtype
    dq = torch.empty(q3.shape, dtype=odt, device=q3.device)
    bh, s, d = q3.shape
    _call("flash_attention_bwd_dq", q3.device,
          q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
          m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(),
          # tpu-dist: ignore[TD001] — host arguments of the launch, no tensor
          bh, s, d, _DTYPE_CODES[q3.dtype], _DTYPE_CODES[odt], int(bool(causal)))
    _count_launch(flash_bwd_dq, q3.dtype)
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.launches_mma = 0


def flash_bwd(q3, k3, v3, o3, m, l, do3, causal: bool = False, *,
              delta: Optional[torch.Tensor] = None,
              grad_dtype: Optional[torch.dtype] = None):
    """The FlashAttention-2 backward of :func:`flash_fwd` (``_bwd_pallas``):
    ``(dq, dk, dv)``. ``do3`` may be a strided view (autograd hands one
    over): it is copied to the kernels' layout. ``delta`` (``rowsum(do *
    o)``, [BH, S] f32) may be passed precomputed, as the ring backward
    does; ``grad_dtype`` overrides the output dtypes."""
    do3 = do3.contiguous()
    if o3.shape != q3.shape:
        raise ValueError(f"o has shape {tuple(o3.shape)}, q {tuple(q3.shape)}")
    if delta is None:
        delta = _delta(do3, o3)
    dk, dv = flash_bwd_dkdv(q3, k3, v3, do3, m, l, delta, causal, grad_dtype)
    dq = flash_bwd_dq(q3, k3, v3, do3, m, l, delta, causal, grad_dtype)
    return dq, dk, dv


def attention_flops(q3, k3) -> int:
    """Model FLOPs of one attention forward on [BH, S_q, D] / [BH, S_k, D]:
    ``4·BH·S_q·S_k·D``, the two matmuls that ``FlopCounterMode`` counts in
    the plain chain (``nn/attention.py::full_attention``), causal or not.
    The backward is twice this; its recompute of P counts nothing, as MFU
    counts the model's FLOPs."""
    bh, s_q, d = q3.shape
    return 4 * bh * s_q * k3.shape[1] * d


class _FlashAttention(torch.autograd.Function):
    """``_flash``'s ``custom_vjp``: the forward kernel saves (out, m, l),
    the two backward kernels recompute P from them. While a step's cost is
    counted (``obs/costmodel.py::step_cost``), each direction books
    :func:`attention_flops` (twice in the backward) and its tensors' bytes,
    and hides the ops inside it, so the kernels and their plain twins count
    the same, and so does the plain attention chain."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal):
        with costmodel.hidden():
            out, m, l = flash_fwd(q3, k3, v3, causal)
        costmodel.count_kernel(attention_flops(q3, k3), q3, k3, v3, out, m, l)
        ctx.save_for_backward(q3, k3, v3, out, m, l)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, out, m, l = ctx.saved_tensors
        with costmodel.hidden():
            dq, dk, dv = flash_bwd(q3, k3, v3, out, m, l, do3, ctx.causal)
        costmodel.count_kernel(2 * attention_flops(q3, k3), q3, k3, v3, out, m, l, do3,
                               dq, dk, dv)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = False):
    """Attention on [B, S, H, D], drop-in for
    :func:`tpu_dist_torch.nn.attention.full_attention` (f32 softmax
    accumulation, output in ``q.dtype``), differentiable through the
    backward kernels."""
    b, s, h, d = q.shape

    def to3(t):
        # reshape may keep a strided view (b == 1): copy to the kernel's layout
        return t.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()

    out3 = _FlashAttention.apply(to3(q), to3(k), to3(v), causal)
    return out3.reshape(b, h, s, d).permute(0, 2, 1, 3)


# -- the ring composition (sequence parallelism) ---------------------------------
#
# ``_ring_flash`` of the JAX package (``_ring_flash_fwd_impl``,
# ``_ring_flash_bwd``): kernels #1-#3 around a K/V ring, so the ring tiles
# the sequence across ranks and the kernels tile each rank's block. Under
# the ring, causal masking is block-structured: at a rotation the
# ``(my, kv_idx)`` pair is fully unmasked (``kv_idx < my``), the diagonal
# (``kv_idx == my``: the global offsets cancel and the kernels' relative
# causal mask is exactly right) or fully masked (``kv_idx > my``: nothing
# is launched). The forward's partials are f32 (``out_dtype=f32``) and merge
# by their ``(m, l)`` in f32, from JAX's finite ``NEG_INF`` (a literal -inf
# would give ``exp(-inf - -inf)`` = NaN). The backward computes ``delta``
# once from the global ``o`` and ``do``; each rotation runs the dK/dV and dQ
# kernels with it, the global ``(m, l)`` and f32 gradients; dQ accumulates
# at home, and the f32 dK/dV accumulators ride the ring with their K/V
# block and arrive home after ``n`` rotations.
#
# The bodies of one rotation (:func:`ring_fwd_rotation`,
# :func:`ring_bwd_rotation`) are plain functions of their tensors. One
# schedule (``_ring_fwd``, ``_ring_bwd``) loops them over a list of local
# ranks and a pluggable rotation: the P2P ring (:func:`ring_flash_fwd`,
# :func:`ring_flash_bwd`) is one local rank and ``collectives.rotate``, the
# one-process lockstep ring (:func:`ring_flash_lockstep`) all ``n`` ranks
# and a shift of the list. Both take ``ops``: the kernels
# (:data:`KERNEL_OPS`, whose wrappers take the plain versions for CPU
# tensors) or the plain versions everywhere (:data:`PLAIN_OPS`, the
# composition's plain version).


class RingOps(NamedTuple):
    """The three passes a rotation calls: forward, dK/dV, dQ."""

    fwd: Callable
    dkdv: Callable
    dq: Callable


KERNEL_OPS = RingOps(flash_fwd, flash_bwd_dkdv, flash_bwd_dq)
PLAIN_OPS = RingOps(flash_fwd_reference, flash_bwd_dkdv_reference, flash_bwd_dq_reference)


def ring_case(my: int, kv_idx: int, causal: bool) -> str:
    """What rank ``my`` computes against the K/V block of rank ``kv_idx``:
    ``"full"`` (no mask), ``"diag"`` (the kernels' causal mask) or
    ``"masked"`` (nothing: every key lies after every query)."""
    if not causal or kv_idx < my:
        return "full"
    return "diag" if kv_idx == my else "masked"


def ring_fwd_init(q3) -> tuple:
    """The merge's start ``(m, l, acc)``: ``NEG_INF``, 0, 0, all f32."""
    bh, s, d = q3.shape
    return (torch.full((bh, s), NEG_INF, dtype=torch.float32, device=q3.device),
            torch.zeros((bh, s), dtype=torch.float32, device=q3.device),
            torch.zeros((bh, s, d), dtype=torch.float32, device=q3.device))


def ring_fwd_rotation(q3, kk, vv, case: str, m, l, acc, ops: RingOps = KERNEL_OPS) -> tuple:
    """One rotation's forward: the f32 partial ``(out_j, m_j, l_j)`` of
    ``q3`` against the block ``(kk, vv)`` as ``case`` says, merged into the
    running ``(m, l, acc)``; returns the new ones. A ``"masked"`` rotation
    launches nothing (its merge would leave the running stats as they
    are)."""
    if case == "masked":
        return m, l, acc
    out_j, m_j, l_j = ops.fwd(q3, kk, vv, case == "diag", out_dtype=torch.float32)
    m_new = torch.maximum(m, m_j)
    corr = torch.exp(m - m_new)
    corr_j = torch.exp(m_j - m_new)
    acc = acc * corr[..., None] + out_j * (l_j * corr_j)[..., None]
    return m_new, l * corr + l_j * corr_j, acc


def ring_fwd_finish(q3, m, l, acc) -> tuple:
    """``(out, m, l)`` after the last rotation: ``acc / max(l, 1e-30)`` in
    q's dtype, and the global ``(m, l)`` the backward takes."""
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q3.dtype), m, l


def ring_bwd_init(q3, k3) -> tuple:
    """The f32 accumulators ``(dk, dv, dq)`` at 0."""
    return (torch.zeros(k3.shape, dtype=torch.float32, device=k3.device),
            torch.zeros(k3.shape, dtype=torch.float32, device=k3.device),
            torch.zeros(q3.shape, dtype=torch.float32, device=q3.device))


def ring_bwd_rotation(q3, kk, vv, do3, m, l, delta, case: str, dka, dva, dq,
                      ops: RingOps = KERNEL_OPS) -> tuple:
    """One rotation's backward: the dK/dV and dQ passes of ``q3`` against
    ``(kk, vv)`` with the global ``(m, l)`` and ``delta``, in f32, added to
    the block's ``(dka, dva)`` and the home ``dq``, which it returns. A
    ``"masked"`` rotation launches nothing."""
    if case == "masked":
        return dka, dva, dq
    causal = case == "diag"
    dk_j, dv_j = ops.dkdv(q3, kk, vv, do3, m, l, delta, causal, torch.float32)
    dq_j = ops.dq(q3, kk, vv, do3, m, l, delta, causal, torch.float32)
    return dka + dk_j, dva + dv_j, dq + dq_j


def ring_bwd_finish(q3, k3, v3, dka, dva, dq) -> tuple:
    """``(dq, dk, dv)`` in the inputs' dtypes."""
    return dq.to(q3.dtype), dka.to(k3.dtype), dva.to(v3.dtype)


def _ring_fwd(qs, ks, vs, mys, n: int, rotate, causal: bool, ops: RingOps) -> list:
    """The ring forward of the local ranks ``mys`` (their ``[BH, S/n, D]``
    blocks ``qs, ks, vs``) on a ring of ``n``: ``(out, m, l)`` per local
    rank. ``rotate(blocks, kind)`` hands each local rank the tuple of the
    rank before it on the ring. The K/V blocks rotate ``n - 1`` times (the
    last block needs no further trip)."""
    stats = [ring_fwd_init(q) for q in qs]
    kv = list(zip(ks, vs))
    for j in range(n):
        stats = [ring_fwd_rotation(q, kk, vv, ring_case(my, (my - j) % n, causal), *st, ops)
                 for q, (kk, vv), my, st in zip(qs, kv, mys, stats)]
        if j < n - 1:
            kv = rotate(kv, "ring_kv")
    return [ring_fwd_finish(q, *st) for q, st in zip(qs, stats)]


def _ring_bwd(qs, ks, vs, outs, ms, ls, dos, mys, n: int, rotate, causal: bool,
              ops: RingOps) -> list:
    """The ring backward of the local ranks ``mys``: ``(dq, dk, dv)`` per
    local rank. The f32 dK/dV accumulators ride the ring with their K/V
    block, ``n`` trips (the last one home, alone)."""
    dos = [t.contiguous() for t in dos]
    deltas = [_delta(do, o) for do, o in zip(dos, outs)]
    acc = [ring_bwd_init(q, k) for q, k in zip(qs, ks)]
    kv = list(zip(ks, vs))
    for j in range(n):
        acc = [ring_bwd_rotation(q, kk, vv, do, m, l, delta, ring_case(my, (my - j) % n, causal),
                                 *a, ops)
               for q, (kk, vv), do, m, l, delta, my, a in zip(qs, kv, dos, ms, ls, deltas, mys,
                                                              acc)]
        if j < n - 1:
            moved = rotate([(kk, vv, dka, dva) for (kk, vv), (dka, dva, _) in zip(kv, acc)],
                           "ring_kv_grad")
            kv = [t[:2] for t in moved]
        else:
            moved = rotate([a[:2] for a in acc], "ring_kv_grad")
        acc = [(*t[-2:], a[2]) for t, a in zip(moved, acc)]
    return [ring_bwd_finish(q, k, v, *a) for q, k, v, a in zip(qs, ks, vs, acc)]


def _p2p_rotate(seq):
    """The ring of ``seq``'s ranks, one local rank: its tuple goes to the
    next rank in one ``batch_isend_irecv`` (:func:`collectives.rotate`)."""
    def rotate(blocks, kind):
        return [tuple(collectives.rotate(list(blocks[0]), group=seq.group, kind=kind))]
    return rotate


def ring_flash_fwd(q3, k3, v3, seq, causal: bool = False, ops: RingOps = KERNEL_OPS) -> tuple:
    """The ring forward on this rank's ``[BH, S/n, D]`` block, ``seq`` its
    seq group (``.size``, ``.index``, ``.group``): ``(out, m, l)``."""
    return _ring_fwd([q3], [k3], [v3], [seq.index], seq.size, _p2p_rotate(seq), causal, ops)[0]


def ring_flash_bwd(q3, k3, v3, o3, m, l, do3, seq, causal: bool = False,
                   ops: RingOps = KERNEL_OPS) -> tuple:
    """The ring backward: ``(dq, dk, dv)`` of this rank's block."""
    return _ring_bwd([q3], [k3], [v3], [o3], [m], [l], [do3], [seq.index], seq.size,
                     _p2p_rotate(seq), causal, ops)[0]


def ring_flash_lockstep(qs, ks, vs, dos, causal: bool = False,
                        ops: RingOps = KERNEL_OPS) -> dict:
    """The composition for all ``n`` ranks of a ring in one process, round
    by round: each round runs every rank's rotation body, then hands each
    rank's K/V (and dK/dV) block to the next rank in place of the P2P, on
    the schedule of :func:`ring_flash_fwd` and :func:`ring_flash_bwd`.
    ``qs, ks, vs, dos`` are the ranks' ``[BH, S/n, D]`` blocks in ring
    order. Returns per rank ``out``, ``m``, ``l``, ``dq``, ``dk``, ``dv``:
    what the P2P ring of ``n`` ranks gives, bit for bit."""
    n = len(qs)

    def shift(blocks, kind):  # rank p receives rank p-1's blocks
        return [blocks[(p - 1) % n] for p in range(n)]

    fwd = _ring_fwd(qs, ks, vs, range(n), n, shift, causal, ops)
    outs, ms, ls = zip(*fwd)
    bwd = _ring_bwd(qs, ks, vs, outs, ms, ls, dos, range(n), n, shift, causal, ops)
    out = {"out": list(outs), "m": list(ms), "l": list(ls)}
    out.update(zip(("dq", "dk", "dv"), map(list, zip(*bwd))))
    return out


class _RingFlashAttention(torch.autograd.Function):
    """``_ring_flash``'s ``custom_vjp``. While a step's cost is counted,
    each direction books what the plain ring chain
    (``nn/attention.py::ring_attention``) counts, :func:`attention_flops`
    of every one of the ``n`` rotations (twice in the backward), masked
    ones included, so ``flops_per_step`` does not depend on ``attn_impl``
    under sequence parallelism either."""

    @staticmethod
    def forward(ctx, q3, k3, v3, seq, causal):
        with costmodel.hidden():
            out, m, l = ring_flash_fwd(q3, k3, v3, seq, causal)
        costmodel.count_kernel(seq.size * attention_flops(q3, k3), q3, k3, v3, out, m, l)
        ctx.save_for_backward(q3, k3, v3, out, m, l)
        ctx.seq, ctx.causal = seq, causal
        return out

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, out, m, l = ctx.saved_tensors
        with costmodel.hidden():
            dq, dk, dv = ring_flash_bwd(q3, k3, v3, out, m, l, do3, ctx.seq, ctx.causal)
        costmodel.count_kernel(2 * ctx.seq.size * attention_flops(q3, k3), q3, k3, v3, out, m,
                               l, do3, dq, dk, dv)
        return dq, dk, dv, None, None


def ring_flash_attention(q, k, v, seq, *, causal: bool = False):
    """Sequence-parallel flash attention on this rank's ``[B, S/n, H, D]``
    shard of a sequence laid over ``seq`` (the seq group: ``.size``,
    ``.index``, ``.group``; rank ``i`` holds positions ``[i·S/n,
    (i+1)·S/n)``), drop-in for
    :func:`tpu_dist_torch.nn.attention.ring_attention` with each rotation's
    tile computed by the kernels. Differentiable."""
    b, s, h, d = q.shape

    def to3(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()

    out3 = _RingFlashAttention.apply(to3(q), to3(k), to3(v), seq, causal)
    return out3.reshape(b, h, s, d).permute(0, 2, 1, 3)
