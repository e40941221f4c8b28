"""Attention on [B, S, H, D]: the port's counterpart of
``tpu_dist/nn/attention.py``.

* :func:`full_attention`: single-device attention. ``impl="xla"`` is the
  plain einsum/softmax chain (the name is kept from the JAX package, where
  XLA fused it): f32 softmax, probabilities cast to ``q.dtype``.
  ``impl="flash"`` is the CUDA flash kernels
  (:mod:`tpu_dist_torch.ops.flash_attention`), or their plain versions on
  the CPU.
* :func:`ring_attention`: sequence parallelism over a seq group. Q stays
  on its rank while the K/V blocks rotate around the ring
  (:func:`~tpu_dist_torch.comm.collectives.ring_rotate`, a P2P exchange
  with the neighbours), accumulated by the online softmax (running max
  ``m``, normaliser ``l``, accumulator ``acc``), so no rank holds more than
  an ``[S/n, S/n]`` block of scores. ``causal`` masks by global position:
  rank ``i`` holds positions ``[i·S/n, (i+1)·S/n)``. Differentiated by
  autograd through the rotations. With ``impl="flash"`` the ring runs the
  kernels instead (:func:`~tpu_dist_torch.ops.flash_attention.ring_flash_attention`).
* :func:`ulysses_attention`: the all-to-all scheme. One stacked exchange
  of q/k/v trades tokens for heads, so each rank holds the whole sequence
  for ``H/n`` heads and runs :func:`full_attention` on it (the flash
  kernels included); a second exchange restores the token shards. Needs
  ``heads % n == 0``.
* :func:`attention`: the dispatch the model calls.

A seq group is what a JAX axis name selects inside ``shard_map``: an
object with the group's ``size``, this rank's ``index`` in it and its
process ``group`` (:class:`tpu_dist_torch.comm.mesh.AxisGroup`). The
implementation is passed explicitly; there is no process-global default.
"""

from __future__ import annotations

import math

import torch

from tpu_dist_torch.comm import collectives
from tpu_dist_torch.ops.flash_attention import flash_attention, ring_flash_attention

IMPLS = ("xla", "flash")
SP_MODES = ("ring", "ulysses")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be 'xla' or 'flash', got {impl!r}")


def full_attention(q, k, v, *, causal: bool = False, impl: str = "xla"):
    """[B,S,H,D] x3 -> [B,S,H,D]. Softmax in f32 whatever the input dtype."""
    _check_impl(impl)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal)
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def ring_attention(q, k, v, seq, *, causal: bool = False):
    """This rank's [B, S/n, H, D] shard of attention over a sequence laid
    across ``seq`` (the seq group). The K/V blocks rotate ``n - 1`` times;
    the scores and the merge are f32 (module docstring). Output in
    ``q.dtype``."""
    n, my = seq.size, seq.index
    b, s_loc, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full((b, h, s_loc), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    pos = torch.arange(s_loc, device=q.device)
    kk, vv = k, v
    for j in range(n):
        kv_idx = (my - j) % n
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kk.float()) * scale
        if causal:
            visible = (my * s_loc + pos[:, None]) >= (kv_idx * s_loc + pos[None, :])
            s = torch.where(visible, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a row with no visible key yet keeps m at -inf: its correction is 0
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vv.float())
        m = m_new
        if j < n - 1:
            kk, vv = collectives.ring_rotate(kk, vv, group=seq.group, kind="ring_kv")
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ulysses_attention(q, k, v, seq, *, causal: bool = False, impl: str = "xla"):
    """This rank's [B, S/n, H, D] shard of attention by the all-to-all
    scheme over ``seq``: one stacked exchange of q/k/v out ([3, B, S, H/n,
    D] here), :func:`full_attention` with ``impl``, one exchange back.
    Raises unless the heads divide over the group."""
    n, h = seq.size, q.shape[2]
    if h % n:
        raise ValueError(
            f"ulysses sequence parallelism needs heads ({h}) divisible by "
            f"the axis size ({n}); use sp_mode='ring' otherwise"
        )
    qkv = torch.stack((q, k, v))  # [3, B, S/n, H, D]
    qg, kg, vg = collectives.all_to_all_tiled(qkv, 3, 2, group=seq.group, kind="ulysses")
    o = full_attention(qg, kg, vg, causal=causal, impl=impl)
    return collectives.all_to_all_tiled(o, 1, 2, group=seq.group, kind="ulysses")


def attention(q, k, v, *, causal: bool = False, impl: str = "xla", seq=None,
              sp_mode: str = "ring"):
    """Dispatch: with a seq group ``seq``, sequence-parallel attention by
    ``sp_mode`` (the ring, whose ``impl="flash"`` is the ring flash
    composition, or Ulysses, whose local attention takes ``impl``); else
    :func:`full_attention`."""
    _check_impl(impl)
    if seq is None:
        return full_attention(q, k, v, causal=causal, impl=impl)
    if sp_mode == "ulysses":
        return ulysses_attention(q, k, v, seq, causal=causal, impl=impl)
    if sp_mode != "ring":
        raise ValueError(f"sp_mode must be 'ring' or 'ulysses', got {sp_mode!r}")
    if impl == "flash":
        return ring_flash_attention(q, k, v, seq, causal=causal)
    return ring_attention(q, k, v, seq, causal=causal)
