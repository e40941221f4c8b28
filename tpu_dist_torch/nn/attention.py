"""Single-device attention on [B, S, H, D]: the port's counterpart of
``tpu_dist/nn/attention.py`` (``full_attention`` and ``attention``).

``impl="xla"`` is the plain einsum/softmax chain (the name is kept from
the JAX package, where XLA fused it): f32 softmax, probabilities cast to
``q.dtype``. ``impl="flash"`` is the CUDA flash kernel
(:mod:`tpu_dist_torch.ops.flash_attention`), or its plain version on the
CPU. The choice is passed explicitly; there is no process-global
default. Ring and Ulysses sequence parallelism come with the
sequence-parallel slice.
"""

from __future__ import annotations

import math

import torch

from tpu_dist_torch.ops.flash_attention import flash_attention

IMPLS = ("xla", "flash")


def full_attention(q, k, v, *, causal: bool = False, impl: str = "xla"):
    """[B,S,H,D] x3 -> [B,S,H,D]. Softmax in f32 whatever the input dtype."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be 'xla' or 'flash', got {impl!r}")
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


def attention(q, k, v, *, causal: bool = False, impl: str = "xla"):
    """Dispatch point of the model code; today only :func:`full_attention`
    (sequence-parallel variants join it with their slice)."""
    return full_attention(q, k, v, causal=causal, impl=impl)
