"""Pipeline-parallel ViT: the port's counterpart of ``tpu_dist/nn/vit_pp.py``
(``ViTPipelineDef``, ``vit_pp_tiny``).

The architecture of :class:`~tpu_dist_torch.nn.vit.ViT`, its weights drawn
from the same seed, with the transformer blocks split into stages over a
pipe group (``pipe=``, an :class:`~tpu_dist_torch.comm.mesh.AxisGroup`):
the embedding, the position table, ``ln_f`` and the head stay replicated
and run on every rank; each stage holds ``depth / pp`` consecutive blocks of
the STORAGE order and streams ``n_microbatches`` microbatches (default: the
stage count) through :mod:`tpu_dist_torch.parallel.pipeline`.

Storage order is JAX's stacked ``params["blocks"]`` row order. With
``interleave = v > 1`` (and ``pp_stages = S``) stage ``d`` holds the ``v``
non-adjacent virtual stages ``d, d + S, ...``, so the rows are stored
device-major (:func:`storage_perm`, ``ViTPipelineDef._storage_perm``) and
a stage's rows are its ``v`` chunks in order; the sequential path (no pipe
group) runs the blocks back in logical order. Without interleaving the two
orders are one.

With a model group (``tp=``) each block is Megatron's tensor-parallel block
(``nn/vit.py::tp_block_forward``) at its shards, PP×TP when both groups are
given; ``stage=`` is then the joined ``pipe,model`` group of
``comm/mesh.py::pp_mesh``, over which a checkpoint gathers a data row's
shards (by default the joined axis with no process group).
:func:`pipeline_lockstep_forward` runs the stages of one pipe group in one
process.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpu_dist_torch import resolve_device
from tpu_dist_torch.comm import mesh
from tpu_dist_torch.nn import vit
from tpu_dist_torch.parallel import pipeline


def storage_perm(depth: int, interleave: int, pp_stages: int):
    """Block-row permutation logical -> storage (device-major chunks): row
    ``i`` of the storage holds logical block ``perm[i]``. None when
    ``interleave == 1`` (the orders are one)."""
    if interleave <= 1:
        return None
    n, v = pp_stages, interleave
    if n <= 0:
        raise ValueError("interleave > 1 requires pp_stages (stage count)")
    if depth % (n * v):
        raise ValueError(f"depth {depth} must divide into pp_stages*interleave={n * v} chunks")
    bpc = depth // (n * v)  # blocks per chunk (virtual stage)
    rows = []
    for d in range(n):
        for k in range(v):
            j = k * n + d  # logical virtual-stage index
            rows.extend(range(j * bpc, (j + 1) * bpc))
    return np.asarray(rows)


class ViTPipeline(nn.Module):
    """The ``ViTPipelineDef`` fields as a module holding this stage's blocks
    (all of them without a pipe group), in storage order."""

    def __init__(self, image_size: int = 32, patch_size: int = 4, dim: int = 64,
                 depth: int = 4, heads: int = 4, mlp_ratio: int = 4, num_classes: int = 10,
                 interleave: int = 1, pp_stages: int = 0, *, attn_impl: str = "xla",
                 device="cuda", seed: int = 0, pipe=None, tp=None, stage=None):
        super().__init__()
        if interleave < 1:
            raise ValueError(f"pp_interleave must be >= 1, got {interleave}")
        dev = resolve_device(device)
        if pipe is not None:
            chunks = pipe.size * interleave
            if depth % chunks:
                raise ValueError(f"depth {depth} not divisible by pp*interleave={chunks} chunks")
            if interleave > 1 and pp_stages != pipe.size:
                raise ValueError(f"model laid out for pp_stages={pp_stages}, mesh has "
                                 f"{pipe.size} pipeline stages")
        perm = storage_perm(depth, interleave, pp_stages)
        # the whole model drawn from the seed on the host, as ViT draws it,
        # then this stage's storage rows kept
        full = vit.ViT(image_size, patch_size, dim, depth, heads, mlp_ratio, num_classes,
                       attn_impl=attn_impl, device="cpu", seed=seed)
        rows = list(range(depth)) if perm is None else [int(i) for i in perm]
        if pipe is not None:
            per = depth // pipe.size
            rows = rows[pipe.index * per:(pipe.index + 1) * per]
        for name in ("image_size", "patch_size", "dim", "depth", "heads", "mlp_ratio",
                     "num_classes", "attn_impl"):
            setattr(self, name, getattr(full, name))
        self.interleave, self.pp_stages = interleave, pp_stages
        self.patch = full.patch
        self.pos = full.pos
        self.blocks = nn.ModuleList(full.blocks[i] for i in rows)
        self.ln_f = full.ln_f
        self.head = full.head
        self.pipe, self.tp = pipe, tp
        if stage is None and pipe is not None:
            # the stage group of a pipe group (and model group) of no process
            # group: the joined axis, row-major, the model index fastest
            stage = pipe if tp is None else mesh.AxisGroup(
                f"{pipe.name},{tp.name}", pipe.size * tp.size, pipe.index * tp.size + tp.index)
        self.stage = stage
        if tp is not None:
            if heads % tp.size:
                raise ValueError(f"{heads} heads not divisible by tp={tp.size}")
            vit.shard_params_(self, tp)
        self.to(dev)

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def shard_axis(self):
        """The group the parameters are sharded over (None: whole): the
        stage group under a pipe group (the joined ``pipe,model`` one under
        PP×TP), else the model group."""
        return self.stage if self.pipe is not None else self.tp

    def tp_param_specs(self) -> dict:
        """``{parameter name: (axis, torch dim)}`` of the leaves Megatron TP
        shards (``ViTPipelineDef.tp_param_specs``: qkv/mlp1 column-sharded,
        proj/mlp2 row-sharded, the rest replicated), by local block name."""
        return {f"blocks.{i}.{leaf}": (mesh.MODEL_AXIS, dim)
                for i in range(len(self.blocks)) for leaf, dim in vit.TP_BLOCK_SPECS.items()}

    def pp_param_specs(self) -> dict:
        """``{parameter name: (axis, None)}`` of the leaves a stage holds
        alone (``ViTPipelineDef.pp_param_specs``): every block leaf, which
        JAX shards over the pipe axis on its stacked depth dimension and the
        port keeps as the stage's rows (no torch dimension is cut); the
        embedding, positions, ``ln_f`` and head replicated."""
        return {n: (mesh.PIPE_AXIS, None) for n, _ in self.named_parameters()
                if n.startswith("blocks.")}

    def pp_tp_param_specs(self) -> dict:
        """Megatron PP×TP (``ViTPipelineDef.pp_tp_param_specs``): every block
        leaf over the pipe axis, its TP shards over the model axis too
        (``((pipe, model), torch dim)``)."""
        tp = self.tp_param_specs()
        return {n: ((mesh.PIPE_AXIS, mesh.MODEL_AXIS), tp[n][1]) if n in tp else spec
                for n, spec in self.pp_param_specs().items()}

    def param_specs(self) -> dict:
        """The leaves cut along a torch dimension as the model is built
        (:meth:`tp_param_specs` under a model group, else none: a stage's
        rows are whole); the bridge and :func:`vit.shard_params_` cut by
        them."""
        return self.tp_param_specs() if self.tp is not None else {}

    def _embed(self, x):
        t = vit._dense(self.patch, vit.patchify(x, self.patch_size))
        vit.check_pos_capacity(t.shape[1], self.pos, self.image_size, self.patch_size)
        return t + self.pos[: t.shape[1]].to(t.dtype)[None]

    def _finish(self, t):
        return vit._dense(self.head, vit._ln(self.ln_f, t).mean(dim=1))

    def _chunk(self, k: int, h):
        """Chunk ``k`` of this stage's blocks (virtual stage ``k·S +
        index``) on ``h``."""
        per = len(self.blocks) // self.interleave
        for i in range(k * per, (k + 1) * per):
            h = self.blocks[i](h, self.attn_impl, tp=self.tp)
        return h

    def forward(self, x, n_microbatches: int = 0):
        """Logits of images ``x`` [B, H, W, 3]: without a pipe group every
        block in logical order; with one, the batch split into
        ``n_microbatches`` (default: the stage count) and streamed through
        the stages (GPipe, or the interleaved schedule)."""
        t = self._embed(x)
        if self.pipe is None:
            perm = storage_perm(self.depth, self.interleave, self.pp_stages)
            order = range(len(self.blocks)) if perm is None else np.argsort(perm)
            for i in order:  # storage is device-major: back to logical order
                t = self.blocks[int(i)](t, self.attn_impl, tp=self.tp)
            return self._finish(t)
        b = t.shape[0]
        micro = _microbatches(t, n_microbatches or self.pipe.size)
        out = pipeline.pipeline_apply_interleaved(self._chunk, micro, self.pipe, self.interleave)
        return self._finish(out.reshape(b, *t.shape[1:]))


def _microbatches(t, m: int):
    b = t.shape[0]
    if b % m:
        raise ValueError(f"batch {b} must divide into {m} microbatches")
    return t.reshape(m, b // m, *t.shape[1:])


def vit_pp_tiny(num_classes: int = 10, image_size: int = 32, **kw) -> ViTPipeline:
    return ViTPipeline(image_size=image_size, num_classes=num_classes, **kw)


def pipeline_lockstep_forward(stages: list, x, n_microbatches: int = 0):
    """The logits of a pipe group whose stages are modules of one process:
    ``stages[d]`` is stage ``d``'s :class:`ViTPipeline` (``pipe=AxisGroup(
    "pipe", n, d)``, no process group). The replicated leaves are the first
    stage's; the stages' chunks run through
    :func:`~tpu_dist_torch.parallel.pipeline.pipeline_lockstep`, where the
    handoffs would move them. Autograd through it gives each stage's blocks
    the gradients that rank would take, and the replicated leaves theirs
    once."""
    lead = stages[0]
    t = lead._embed(x)
    micro = _microbatches(t, n_microbatches or len(stages))
    out = pipeline.pipeline_lockstep([s._chunk for s in stages], micro, lead.interleave)
    return lead._finish(out.reshape(t.shape))
