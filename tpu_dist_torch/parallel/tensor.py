"""Tensor (model) parallelism over a model group: the port's counterpart of
``tpu_dist/parallel/tensor.py``.

Megatron's column- and row-parallel linear layers. The weight lives
sharded over the model group (each rank holds a slice) and the
activations pass through with one all-reduce a pair:

    h = column_parallel_dense(copy_to_tp(x), w1_local, b1_local)  # [.., d_ff/n]
    h = gelu(h)                                                  # stays local
    y = row_parallel_dense(h, w2_local, tp, b2)                  # all-reduce

The weights are ``nn.Linear``'s ``[out, in]``: JAX's ``[din, dout]`` column
shard (its output features) is a ROW block of the weight here, and its row
shard (the input features) a column block. :func:`shard_columns` and
:func:`shard_rows` keep JAX's names for what is sharded (the output or
the input features) and take the torch layout.

``tp`` is the model group, a :class:`~tpu_dist_torch.comm.mesh.AxisGroup`;
the conjugate pair is :func:`~tpu_dist_torch.comm.collectives.copy_to_tp`
and :func:`~tpu_dist_torch.comm.collectives.reduce_from_tp`.
"""

from __future__ import annotations

import torch.nn.functional as F

from tpu_dist_torch.comm import collectives


def shard(t, dim: int, axis_size: int, index: int):
    """Block ``index`` of ``axis_size`` equal blocks of ``t`` (a tensor or a
    numpy array) along ``dim``: a view. The one slicer of the port's model
    parallelism: the models cut their weights with it and the bridge its
    full arrays."""
    if t.shape[dim] % axis_size:
        raise ValueError(f"{t.shape[dim]} does not divide over {axis_size}")
    step = t.shape[dim] // axis_size
    return t[(slice(None),) * dim + (slice(index * step, (index + 1) * step),)]


def shard_columns(weight, axis_size: int, index: int):
    """This rank's output-feature block (JAX's column shard) of an
    ``[out, in]`` weight or an ``[out]`` bias: rows ``index·out/n`` on."""
    return shard(weight, 0, axis_size, index)


def shard_rows(weight, axis_size: int, index: int):
    """This rank's input-feature block (JAX's row shard) of an ``[out, in]``
    weight: columns ``index·in/n`` on."""
    return shard(weight, 1, axis_size, index)


def column_parallel_dense(x, w_local, b_local=None):
    """``x @ W`` with ``W`` column-sharded: ``x`` is the same on every rank
    of the model group (fed through ``copy_to_tp``); the output is this
    rank's slice of the features. No communication."""
    return F.linear(x, w_local.to(x.dtype), None if b_local is None else b_local.to(x.dtype))


def row_parallel_dense(x_local, w_local, tp, b=None):
    """``x @ W`` with ``W`` row-sharded over the model group ``tp`` (None:
    no tensor parallelism, the whole ``W``) and ``x_local`` this rank's
    slice of the input features: one all-reduce (``reduce_from_tp``) makes
    the output the same on every rank. The (replicated) bias is added after
    the reduce, so it is not multiplied by the group's size."""
    y = F.linear(x_local, w_local.to(x_local.dtype))
    if tp is not None:
        y = collectives.reduce_from_tp(y, group=tp.group)
    return y if b is None else y + b.to(y.dtype)


def lockstep_row_parallel_dense(xs: list, ws: list):
    """:func:`row_parallel_dense` (no bias) of a lockstep group, whose ranks
    are virtual ranks of one process: ``xs[r]`` and ``ws[r]`` are rank
    ``r``'s input slice and weight shard, and their partial products are
    summed in rank order, where the all-reduce would sum them."""
    y = F.linear(xs[0], ws[0].to(xs[0].dtype))
    for x, w in zip(xs[1:], ws[1:]):
        y = y + F.linear(x, w.to(x.dtype))
    return y
