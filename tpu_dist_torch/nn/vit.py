"""Vision Transformer: the port's counterpart of ``tpu_dist/nn/vit.py``
(``ViTDef`` on its single-device, sequence-parallel and tensor-parallel
paths, ``tp_block_forward``, ``tp_param_specs``).

Layout and numerics follow the JAX model exactly, so weights carried by
:mod:`tpu_dist_torch.bridge` give the same logits:

* patches are a reshape in ``(ph, pw, c)`` order plus a Linear, not a
  Conv2d (whose kernel would need its weights permuted);
* the qkv output is reshaped ``[b, s, heads, 3, h_dim]``;
* LayerNorm has eps 1e-6, is computed in f32 and cast back;
* GELU is the tanh approximation (``jax.nn.gelu``'s default);
* biases are cast to the activation dtype;
* tokens are mean-pooled (there is no cls token); smaller images use the
  leading rows of the position table, more tokens than it holds is an
  error.

Input is NHWC ``[B, H, W, 3]`` float images; the output is the logits.

With a seq group (``seq=``, :class:`tpu_dist_torch.comm.mesh.AxisGroup`)
the forward is the JAX ``apply``'s ``seq_axis`` branch: the images arrive
the same on every rank of the group, each rank keeps its contiguous chunk
of the patch tokens (or takes ``tokens=`` already cut, with ``pos_offset``
the global index of its first token) and the matching rows of the
position table, every block's attention runs sequence-parallel
(``sp_mode``), and the pooled tokens are averaged over the group. That
average is a differentiable sum (its backward sums the cotangent, the
transpose of JAX's ``pmean``), so each rank's gradients are those of a full
replica of the loss and the step means them over the group.

With a model group (``tp=``, Megatron tensor parallelism) the module holds
this rank's shards: qkv and mlp1 column-sharded (``heads / tp`` local
heads, ``mlp_ratio·dim / tp`` local hidden), proj and mlp2 row-sharded,
every other leaf replicated (:meth:`ViT.tp_param_specs`). Each block
feeds its attention and its MLP through ``copy_to_tp`` and merges them
with one ``reduce_from_tp`` each; proj's and mlp2's biases are added after
the reduce. The weights are drawn at full width from ``seed`` on every rank
and cut, so a TP rank holds the one-device model's slices. TP composes
with ``seq`` (the attention of the local heads runs sequence-parallel).
:func:`tp_lockstep_forward` runs a whole group's shards in one process.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_dist_torch import resolve_device
from tpu_dist_torch.comm import collectives, mesh
from tpu_dist_torch.nn import attention as attn_lib
from tpu_dist_torch.parallel import tensor


def _ln(mod: nn.LayerNorm, x):
    # scale and bias pass through the activation dtype, as the JAX step's
    # cast of the whole parameter tree to the compute dtype has them
    w, b = (t.to(x.dtype).float() for t in (mod.weight, mod.bias))
    return F.layer_norm(x.float(), mod.normalized_shape, w, b, mod.eps).to(x.dtype)


def _dense(mod: nn.Linear, x, bias: bool = True):
    w = mod.weight.to(x.dtype)
    return F.linear(x, w, mod.bias.to(x.dtype) if bias else None)


def patchify(x, patch_size: int):
    """[B, H, W, C] -> [B, N, patch_size**2 * C] in row-major patch order."""
    b, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def check_pos_capacity(n_tokens: int, pos_table, image_size: int, patch_size: int):
    """Loud error when the input has more patch tokens than the position
    table holds (smaller inputs use its leading rows)."""
    if n_tokens > pos_table.shape[0]:
        raise ValueError(
            f"input has {n_tokens} patch tokens but the positional embedding "
            f"holds {pos_table.shape[0]} (image_size={image_size}, "
            f"patch_size={patch_size}); build the model with the matching "
            f"image_size"
        )


def _copy(v, tp):
    """``copy_to_tp`` over the model group ``tp`` (None: the identity)."""
    return v if tp is None else collectives.copy_to_tp(v, group=tp.group)


def _local_attention(blk, y, h_dim: int, attn_impl: str, seq=None, sp_mode: str = "ring"):
    """The block's attention at its local heads, before proj: qkv is
    column-sharded, laid ``[heads, 3, h_dim]``, so a contiguous shard is
    whole heads. ``[B, S, local heads · h_dim]``."""
    qkv = tensor.column_parallel_dense(y, blk.qkv.weight, blk.qkv.bias)
    b, s, qkv_dim = qkv.shape
    h_loc = qkv_dim // (3 * h_dim)
    qkv = qkv.reshape(b, s, h_loc, 3, h_dim)
    q, k, v = (qkv[:, :, :, i, :] for i in range(3))
    o = attn_lib.attention(q, k, v, impl=attn_impl, seq=seq, sp_mode=sp_mode)
    return o.reshape(b, s, h_loc * h_dim)


def _local_mlp_hidden(blk, y):
    """gelu of the column-sharded mlp1: this rank's slice of the hidden."""
    return F.gelu(tensor.column_parallel_dense(y, blk.mlp1.weight, blk.mlp1.bias),
                  approximate="tanh")


def tp_block_forward(blk, t, h_dim: int, *, attn_impl: str, seq=None,
                     sp_mode: str = "ring", tp=None):
    """One transformer block on [B, S, D] (``tpu_dist/nn/vit.py::
    tp_block_forward``): qkv and mlp1 column-sharded (local heads, local
    hidden), proj and mlp2 row-sharded, each pair joined by the conjugate
    pair over the model group ``tp`` (an
    :class:`~tpu_dist_torch.comm.mesh.AxisGroup`; None: no tensor
    parallelism). The row-parallel biases are added after the residual sum,
    in JAX's order."""
    y = _copy(_ln(blk.ln1, t), tp)
    o = _local_attention(blk, y, h_dim, attn_impl, seq, sp_mode)
    t = t + tensor.row_parallel_dense(o, blk.proj.weight, tp) + blk.proj.bias.to(t.dtype)
    y = _copy(_ln(blk.ln2, t), tp)
    h = _local_mlp_hidden(blk, y)
    return t + tensor.row_parallel_dense(h, blk.mlp2.weight, tp) + blk.mlp2.bias.to(t.dtype)


class Block(nn.Module):
    """One pre-norm transformer block, its qkv/mlp1 columns and proj/mlp2
    rows cut into shards when the model is tensor-parallel
    (:func:`shard_params_`)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.heads = heads
        self.h_dim = dim // heads
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp1 = nn.Linear(dim, mlp_ratio * dim)
        self.mlp2 = nn.Linear(mlp_ratio * dim, dim)

    def forward(self, t, attn_impl: str, seq=None, sp_mode: str = "ring", tp=None):
        return tp_block_forward(self, t, self.h_dim, attn_impl=attn_impl, seq=seq,
                                sp_mode=sp_mode, tp=tp)


#: Megatron TP's shard of each block leaf (``ViTDef.tp_param_specs``), by its
#: name in the block and its dimension in the torch layout: qkv and mlp1
#: column-sharded (rows of the ``[out, in]`` weight, and the bias), proj and
#: mlp2 row-sharded (columns of the weight; their bias is replicated).
TP_BLOCK_SPECS = {"qkv.weight": 0, "qkv.bias": 0, "proj.weight": 1,
                  "mlp1.weight": 0, "mlp1.bias": 0, "mlp2.weight": 1}


def shard_params_(model: nn.Module, axis) -> None:
    """Replace each parameter that ``model.param_specs()`` names by this
    rank's block of it along its dimension (``axis.index`` of
    ``axis.size``), in place: the weights drawn at full width for every
    rank alike become this rank's shards."""
    with torch.no_grad():
        for name, (_, dim) in model.param_specs().items():
            prefix, _, leaf = name.rpartition(".")
            mod = model.get_submodule(prefix)
            try:
                part = tensor.shard(getattr(mod, leaf), dim, axis.size, axis.index)
            except ValueError as e:
                raise ValueError(f"{name}: {e}") from None
            setattr(mod, leaf, nn.Parameter(part.clone()))
            if isinstance(mod, nn.Linear):
                mod.out_features, mod.in_features = mod.weight.shape


class ViT(nn.Module):
    """The ``ViTDef`` fields as a module. Weights are drawn from
    ``seed`` with an explicit :class:`torch.Generator`, in the JAX
    package's distributions (normal / sqrt(fan_in) kernels, zero biases,
    normal * 0.02 positions); a bridged state dict replaces them."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, dim: int = 768,
                 depth: int = 12, heads: int = 12, mlp_ratio: int = 4,
                 num_classes: int = 1000, pool: str = "mean", *,
                 attn_impl: str = "xla", device="cuda", seed: int = 0, tp=None):
        super().__init__()
        if pool != "mean":
            raise ValueError(f"only mean pooling exists (no cls token), got {pool!r}")
        if attn_impl not in attn_lib.IMPLS:
            raise ValueError(f"attn_impl must be 'xla' or 'flash', got {attn_impl!r}")
        dev = resolve_device(device)
        self.image_size = image_size
        self.patch_size = patch_size
        self.dim = dim
        self.depth = depth
        self.heads = heads
        self.mlp_ratio = mlp_ratio
        self.num_classes = num_classes
        self.pool = pool
        self.attn_impl = attn_impl
        self.patch = nn.Linear(patch_size * patch_size * 3, dim)
        self.pos = nn.Parameter(torch.empty(self.n_patches, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, mlp_ratio) for _ in range(depth))
        self.ln_f = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, num_classes)
        self._init_weights(torch.Generator().manual_seed(seed))
        # Megatron TP: every rank draws the full weights from the seed and
        # keeps its shards (``heads / tp`` local heads)
        self.tp = tp
        if tp is not None:
            if heads % tp.size:
                raise ValueError(f"{heads} heads not divisible by tp={tp.size}")
            shard_params_(self, tp)
        self.to(dev)

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def shard_axis(self):
        """The model group the parameters are sharded over (None: whole)."""
        return self.tp

    def tp_param_specs(self) -> dict:
        """``{parameter name: (axis, torch dim)}`` of the leaves Megatron TP
        shards (``ViTDef.tp_param_specs``; every other leaf is replicated).
        The bridge and the checkpoint slice and gather by it."""
        return {f"blocks.{i}.{leaf}": (mesh.MODEL_AXIS, dim)
                for i in range(self.depth) for leaf, dim in TP_BLOCK_SPECS.items()}

    def param_specs(self) -> dict:
        """The sharded leaves of this model as it is built: the TP specs under
        a model group, else none."""
        return self.tp_param_specs() if self.tp is not None else {}

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fan_in = mod.weight.shape[1]
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * fan_in ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.pos.copy_(torch.randn(self.pos.shape, generator=gen) * 0.02)

    def forward(self, x=None, *, seq=None, sp_mode: str = "ring", tokens=None,
                pos_offset: int = 0):
        """Logits of images ``x`` [B, H, W, 3], or of patch ``tokens`` [B,
        S_local, patch_dim] already cut for this rank of ``seq`` (module
        docstring)."""
        if tokens is None:
            tokens = patchify(x, self.patch_size)
            if seq is not None:
                # the images arrived the same on every rank of the group:
                # each keeps its contiguous token chunk
                if tokens.shape[1] % seq.size:
                    raise ValueError(
                        f"sequence of {tokens.shape[1]} patch tokens does not "
                        f"divide over {seq.size} sequence-parallel devices — "
                        f"tokens would be silently dropped"
                    )
                s_loc = tokens.shape[1] // seq.size
                tokens = tokens[:, seq.index * s_loc:(seq.index + 1) * s_loc]
        t = _dense(self.patch, tokens)
        if seq is not None:
            start = seq.index * t.shape[1] + pos_offset
            pos = self.pos[start:start + t.shape[1]]
        else:
            check_pos_capacity(t.shape[1], self.pos, self.image_size, self.patch_size)
            pos = self.pos[: t.shape[1]]  # smaller inputs use the leading rows
        t = t + pos.to(t.dtype)[None]
        for blk in self.blocks:
            t = blk(t, self.attn_impl, seq, sp_mode, self.tp)
        pooled = _ln(self.ln_f, t).mean(dim=1)
        if seq is not None:
            # the token mean over the whole (sharded) sequence
            pooled = collectives.sum_across_ranks(pooled, group=seq.group,
                                                  kind="seq_pool") / seq.size
        return _dense(self.head, pooled)


def vit_b16(num_classes: int = 1000, image_size: int = 224, **kw) -> ViT:
    """ViT-B/16 (86,566,120 parameters at 1000 classes)."""
    return ViT(image_size=image_size, patch_size=16, dim=768, depth=12,
               heads=12, num_classes=num_classes, **kw)


def vit_s16(num_classes: int = 1000, image_size: int = 224, **kw) -> ViT:
    return ViT(image_size=image_size, patch_size=16, dim=384, depth=12,
               heads=6, num_classes=num_classes, **kw)


def vit_tiny(num_classes: int = 10, image_size: int = 32, **kw) -> ViT:
    """CIFAR-sized: patch 4 over 32x32 -> 64 tokens; for tests and smokes."""
    return ViT(image_size=image_size, patch_size=4, dim=64, depth=2,
               heads=4, num_classes=num_classes, **kw)


def tp_lockstep_forward(shards: list, x):
    """The logits of a tensor-parallel group whose ranks are virtual ranks of
    one process: ``shards[r]`` is rank ``r``'s TP ViT (``tp=AxisGroup(
    "model", n, r)``, no process group). Each block runs every shard's
    local attention and MLP and sums their row-parallel partials in rank
    order (``tensor.lockstep_row_parallel_dense``), as
    :func:`tp_block_forward` does through the all-reduce; the replicated
    leaves are the first shard's. Autograd through it gives each shard's
    weights the gradient that rank would take, and the replicated leaves
    theirs once."""
    lead = shards[0]
    t = _dense(lead.patch, patchify(x, lead.patch_size))
    check_pos_capacity(t.shape[1], lead.pos, lead.image_size, lead.patch_size)
    t = t + lead.pos[: t.shape[1]].to(t.dtype)[None]
    h_dim = lead.dim // lead.heads
    for i in range(lead.depth):
        blks = [s.blocks[i] for s in shards]
        y = _ln(blks[0].ln1, t)
        os_ = [_local_attention(b, y, h_dim, lead.attn_impl) for b in blks]
        t = (t + tensor.lockstep_row_parallel_dense(os_, [b.proj.weight for b in blks])
             + blks[0].proj.bias.to(t.dtype))
        y = _ln(blks[0].ln2, t)
        hs = [_local_mlp_hidden(b, y) for b in blks]
        t = (t + tensor.lockstep_row_parallel_dense(hs, [b.mlp2.weight for b in blks])
             + blks[0].mlp2.bias.to(t.dtype))
    return _dense(lead.head, _ln(lead.ln_f, t).mean(dim=1))
