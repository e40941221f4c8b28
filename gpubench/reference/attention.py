"""Softmax attention in float32, a block of query rows at a time.

At 4,096 tokens one layer's float32 scores for batch 8 and 12 heads are
6.4 GB, so neither the forward nor the backward holds them whole: the
forward keeps the output and each row's log-sum-exp, and the backward
works the probabilities of one block of rows out again from them. That is
the same mathematics as plain ``softmax(q kᵀ / sqrt(d)) v`` and its
gradients, in another order of summation.
"""

from __future__ import annotations

import math

import torch

SCORE_BYTES = 1 << 30  # float32 scores a block may hold


def _rows(bh: int, s: int) -> int:
    return max(1, min(s, SCORE_BYTES // (4 * bh * s)))


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        bh, s, d = q.shape
        scale = 1.0 / math.sqrt(d)
        out = torch.empty_like(q)
        lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
        step = _rows(bh, k.shape[1])
        for r in range(0, s, step):
            sc = torch.bmm(q[:, r:r + step], k.transpose(1, 2)) * scale
            lse[:, r:r + step] = torch.logsumexp(sc, dim=-1)
            out[:, r:r + step] = torch.bmm(torch.exp(sc - lse[:, r:r + step, None]), v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bh, s, d = q.shape
        scale = 1.0 / math.sqrt(d)
        delta = (do * out).sum(dim=-1)
        dq, dk, dv = torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
        step = _rows(bh, k.shape[1])
        for r in range(0, s, step):
            rows = slice(r, r + step)
            p = torch.exp(torch.bmm(q[:, rows], k.transpose(1, 2)) * scale - lse[:, rows, None])
            dv += torch.bmm(p.transpose(1, 2), do[:, rows])
            ds = p * (torch.bmm(do[:, rows], v.transpose(1, 2)) - delta[:, rows, None]) * scale
            dq[:, rows] = torch.bmm(ds, k)
            dk += torch.bmm(ds.transpose(1, 2), q[:, rows])
        return dq, dk, dv


def attention(q, k, v):
    """``[BH, S, D]`` float32 q, k, v -> ``[BH, S, D]``."""
    return _Attention.apply(q, k, v)
