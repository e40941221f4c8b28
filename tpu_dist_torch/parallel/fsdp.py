"""Fully-sharded data parallelism (FSDP, ZeRO-3) over the data axis: the
port's counterpart of ``tpu_dist/parallel/fsdp.py`` (``fsdp_specs``,
``compose_fsdp_specs``, ``make_fsdp_train_step``, ``make_fsdp_eval_step``).

The JAX engine writes the step in the global view and lets GSPMD insert
the gathers and reduce-scatters from per-leaf ``PartitionSpec`` s; the
port writes them by hand, as :class:`~tpu_dist_torch.train.step._ZeroOne`
writes ZeRO-1's, over the collectives of
:mod:`tpu_dist_torch.comm.collectives`:

* Which leaves shard, and along which dimension, is JAX's decision on
  JAX's layout (:func:`fsdp_specs`, :func:`compose_fsdp_specs`: the largest
  dimension the data extent divides, ties toward the leading one, leaves of
  at least ``min_size`` elements, a dimension a model axis claims skipped),
  mapped onto the torch dimension that holds the same axis
  (:func:`fsdp_dims`). A rank's shard of a leaf is then the window JAX's
  device holds, its sharded checkpoint pieces are JAX's, and so is the
  memory saving.
* :class:`FSDPShards` holds this rank's shards, the persistent tensors.
  The model keeps each sharded parameter at its full shape, its data a
  one-element zero view between steps (reads give zeros, writes raise);
  :meth:`FSDPShards.gather` fills it by the all-gather before use
  (``comm.all_gather.fsdp_params``) and :meth:`FSDPShards.release` drops
  it again. Replicated leaves stay in the model as they are.
* The step (:func:`make_fsdp_train_step`), numerically the plain
  data-parallel step: gather, the forward and backward of ``K`` chunks in
  JAX's chunk order with SyncBN over the group (the global batch's
  statistics, as GSPMD's global view has them), release, the
  reduce-scatter of each sharded leaf's gradient into this rank's shard
  (``comm.reduce_scatter.fsdp_grad``) and the mean over the group of the
  replicated leaves' (``comm.all_reduce.grad``), the global-norm clip (each
  shard's squares summed over its groups), and the optimizer's update on
  the shards: SGD (plain), AdamW, LARS and LAMB, the last two with each
  leaf's norm summed over its groups (:meth:`FSDPShards.leaf_norms`). The
  optimizer state is ``optimizer.init(shards.entries)``: it mirrors the
  shards, as ``optimizer.state_specs`` lays it out in JAX.
* Under FSDP×TP (``ViT(tp=)``, the data axis of
  :func:`~tpu_dist_torch.comm.mesh.tp_mesh`) a TP shard is sharded again
  over the data axis along a dimension TP leaves free; every reduce above
  runs over the data group, and the squares of a TP shard over the model
  group too.
* A lockstep group (``lockstep=n`` and no axis): one process holds all
  ``n`` virtual ranks' shards and runs the global batch through one
  forward (its BatchNorm statistics are the global batch's by
  construction); the lockstep collectives cut the one gradient into the
  ``n`` shards and join them again. It is what proves the sharded update
  at full width on one card.

Numerics: the reduce-scatter and the group-summed norms add in another
order than the plain step's all-reduce and ``vector_norm``, so the two
agree to f32 rounding, not bit for bit (``tests/test_torch_fsdp.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from tpu_dist_torch.comm import collectives, mesh
from tpu_dist_torch.parallel import tensor

DATA_AXIS = mesh.DATA_AXIS

# the JAX engine's refusal of a compressed wire (tpu_dist/parallel/fsdp.py:192-198)
_COMPRESSION_REFUSAL = (
    "grad_compression={!r} cannot apply under the GSPMD/FSDP engine (collectives are "
    "partitioner-inserted, not hookable) — use the shard_map engines (plain DP / --zero1) "
    "for compressed gradient wire formats")


def _tree_map(fn, tree, *others):
    """``fn(leaf, *other leaves)`` over nested dicts and lists of ``tree``;
    ``others`` are walked in step with it (their nodes at ``tree``'s
    leaves, tuples or None, are passed whole)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree))
    return fn(tree, *others)


def _order(shape) -> list:
    """The dimensions of ``shape``, largest first, ties toward the leading."""
    return sorted(range(len(shape)), key=lambda d: (-int(shape[d]), d))


def fsdp_specs(params, n: int, axis: str = DATA_AXIS, min_size: int = 1024):
    """Per-leaf partition spec (a tuple, as ``tuple(PartitionSpec)``) of a
    JAX-layout parameter tree (nested dicts and lists of arrays) sharded
    over a data axis of ``n`` ranks: the largest dimension ``n`` divides
    carries ``axis`` (ties toward the leading one); leaves under
    ``min_size`` elements, or with no divisible dimension, are ``()``
    (replicated)."""

    def spec(x):
        shape = tuple(np.shape(x))
        if n <= 1 or not shape or int(np.prod(shape)) < min_size:
            return ()
        for d in _order(shape):
            if int(shape[d]) % n == 0:
                entry = [None] * len(shape)
                entry[d] = axis
                return tuple(entry)
        return ()

    return _tree_map(spec, params)


def compose_fsdp_specs(params, n: int, model_specs, *, data_axis: str = DATA_AXIS,
                       min_size: int = 1024):
    """FSDP×TP: ``model_specs`` (per-leaf tuples of a model axis name or
    None along each dimension, or None for a replicated leaf; the
    Megatron specs) with the data axis laid over the largest dimension no
    model axis claims and ``n`` divides (ties toward the leading one), for
    leaves of at least ``min_size`` elements. Trailing None entries are
    dropped, as ``PartitionSpec`` s are."""

    def compose(x, mspec):
        shape = tuple(np.shape(x))
        entries = list(mspec) if mspec is not None else []
        entries += [None] * (len(shape) - len(entries))
        if n > 1 and shape and int(np.prod(shape)) >= min_size:
            for d in _order(shape):
                if entries[d] is None and int(shape[d]) % n == 0:
                    entries[d] = data_axis
                    break
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    return _tree_map(compose, params, model_specs)


def fsdp_dims(model, n: int, min_size: int = 1024) -> dict:
    """``{parameter name: torch dim}`` of the leaves FSDP shards over a
    data axis of ``n`` ranks (the others are replicated): JAX's choice on
    the JAX layout of the full-width parameters (:func:`compose_fsdp_specs`
    over the model's TP specs when it has a model group, else
    :func:`fsdp_specs`), each mapped to the torch dimension of the same
    axis."""
    from tpu_dist_torch import bridge  # noqa: PLC0415

    layout = bridge.leaf_layout(model)
    params = bridge.keystr_leaves(bridge.jax_layout_template(model)[0])
    if getattr(model, "shard_axis", None) is not None:
        specs = compose_fsdp_specs(params, n, bridge.jax_model_specs(model), min_size=min_size)
    else:
        specs = fsdp_specs(params, n, min_size=min_size)
    out = {}
    for name, _ in model.named_parameters():
        lay = layout[name]
        spec = specs[lay.key]
        if DATA_AXIS in spec:
            out[name] = lay.perm[spec.index(DATA_AXIS)]
    return out


class FSDPShards:
    """This rank's FSDP shards of ``model``'s parameters (module
    docstring). ``dims`` is :func:`fsdp_dims`'s; ``axis`` the data axis (an
    :class:`~tpu_dist_torch.comm.mesh.AxisGroup`), or ``lockstep=n`` virtual
    ranks in this one process. ``tp`` is the model's model group (FSDP×TP)
    or None. Takes the shards of the model's current weights and releases
    the sharded parameters."""

    def __init__(self, model: torch.nn.Module, dims: dict, *, axis=None, lockstep: int = 0,
                 tp=None):
        if axis is not None and lockstep:
            raise ValueError("FSDPShards takes a data axis or a lockstep group, not both")
        self.model, self.axis, self.tp = model, axis, tp
        self.n = axis.size if axis is not None else max(1, int(lockstep))
        self.lockstep = axis is None and self.n > 1
        self.group = axis.group if axis is not None else None
        #: the data indices of the ranks this process holds
        self.ranks = [axis.index] if axis is not None else list(range(self.n))
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.dims = [dims.get(n) if self.n > 1 else None for n in self.names]
        specs = model.param_specs() if tp is not None else {}
        #: leaves a model group shards too (their squares sum over it)
        self.tp_sharded = [n in specs for n in self.names]
        self.shards = []  # shards[i][k]: held rank k's shard of leaf i
        with torch.no_grad():
            for p, d in zip(self.params, self.dims):
                if d is None:
                    self.shards.append([p])  # replicated: the parameter itself
                else:
                    self.shards.append([tensor.shard(p.detach(), d, self.n, r).clone(
                        memory_format=torch.contiguous_format) for r in self.ranks])
        self.release()

    # -- the optimizer's view: one entry a shard this process holds ------------

    @property
    def entries(self) -> list:
        """Every shard this process holds, leaf-major (a replicated leaf
        once): the tensors the optimizer updates."""
        return [s for leaf in self.shards for s in leaf]

    @property
    def leaf_of(self) -> list:
        """The leaf index of each entry."""
        return [i for i, leaf in enumerate(self.shards) for _ in leaf]

    def sharded(self, i: int) -> bool:
        return self.dims[i] is not None

    def block(self, i: int, k: int) -> tuple:
        """``(dim, start, size)`` of held rank ``k``'s shard of leaf ``i``
        within the model's (TP-local) parameter; ``(None, 0, 0)`` for a
        replicated leaf."""
        d = self.dims[i]
        if d is None:
            return None, 0, 0
        size = self.params[i].shape[d] // self.n
        return d, self.ranks[k] * size, size

    # -- the parameters before and after use -----------------------------------

    def gather(self) -> None:
        """Fill every sharded parameter with its full value: the all-gather
        of its shards over the data group (the join of the held shards in
        a lockstep group)."""
        with torch.no_grad():
            for i, (p, d) in enumerate(zip(self.params, self.dims)):
                if d is None:
                    continue
                if self.lockstep:
                    full = collectives.lockstep_all_gather_dim(self.shards[i], d,
                                                               kind="fsdp_params")
                else:
                    full = collectives.all_gather_dim(self.shards[i][0], d, group=self.group,
                                                      kind="fsdp_params")
                p.data = full

    def release(self) -> None:
        """Drop the sharded parameters' full values: a one-element zero view
        of the same shape takes their place until the next :meth:`gather`."""
        for p, d in zip(self.params, self.dims):
            if d is not None:
                p.data = torch.zeros((), dtype=p.dtype, device=p.device).expand(p.shape)

    @contextlib.contextmanager
    def gathered(self):
        """The full parameters for the length of the block."""
        self.gather()
        try:
            yield self.model
        finally:
            self.release()

    def full_leaves(self, entries: list) -> list:
        """The full (TP-local) value of each leaf from ``entries`` (tensors
        laid as :attr:`entries`, e.g. the momentum): a sharded leaf's shards
        all-gathered over the data group (every rank must call this then),
        a replicated leaf's entry as it is."""
        out, it = [], iter(entries)
        for i, leaf in enumerate(self.shards):
            parts = [next(it) for _ in leaf]
            d = self.dims[i]
            if d is None:
                out.append(parts[0])
            elif self.lockstep:
                out.append(torch.cat(parts, dim=d))
            else:
                out.append(collectives.all_gather(parts[0].detach(), group=self.group, axis=d))
        return out

    def local_entries(self, leaves: list) -> list:
        """The inverse of :meth:`full_leaves`: each full (TP-local) leaf cut
        into the shards this process holds, laid as :attr:`entries`
        (views)."""
        out = []
        for i, full in enumerate(leaves):
            for k in range(len(self.shards[i])):
                d, lo, size = self.block(i, k)
                out.append(full if d is None else full.narrow(d, lo, size))
        return out

    # -- reductions over the groups a leaf lies over ---------------------------

    def _group_sums(self, v: torch.Tensor, kind: str) -> torch.Tensor:
        """``v`` (one value a leaf) summed over the data group for the
        leaves FSDP shards and over the model group for the TP shards."""
        for on, group, size in (([d is not None for d in self.dims], self.group,
                                 1 if self.lockstep else self.n),
                                (self.tp_sharded, self.tp.group if self.tp else None,
                                 self.tp.size if self.tp else 1)):
            if size > 1 and any(on):
                mask = torch.tensor(on, device=v.device)
                part = torch.where(mask, v, torch.zeros_like(v))
                collectives.all_reduce_(part, group=group, kind=kind)
                v = torch.where(mask, part, v)
        return v

    def _leaf_squares(self, entries: list) -> torch.Tensor:
        """Each leaf's sum of squares over the entries this process holds."""
        dev = entries[0].device
        sq = torch.zeros(len(self.shards), dtype=torch.float32, device=dev)
        for i, t in zip(self.leaf_of, entries):
            sq[i] += torch.sum(torch.square(t.float()))
        return sq

    def global_square_norm(self, entries: list, kind: str = "clip") -> torch.Tensor:
        """The squared global norm of ``entries`` (laid as :attr:`entries`):
        each leaf's squares summed over the groups it lies over."""
        return torch.sum(self._group_sums(self._leaf_squares(entries), kind))

    def leaf_norms(self, entries: list) -> list:
        """The norm of each entry's whole leaf (the optimizers'
        ``leaf_norms`` hook: LARS's and LAMB's per-layer norms over the
        shards)."""
        norms = torch.sqrt(self._group_sums(self._leaf_squares(entries), "fsdp_norm"))
        return [norms[i] for i in self.leaf_of]

    def reduce_grads(self, grads: list) -> list:
        """The gradients of the full (TP-local) leaves as the optimizer's
        entries: a sharded leaf's reduce-scattered over the data group into
        this rank's shard, a replicated leaf's meant over the group, both
        divided by the group's size; in a lockstep group the one gradient
        (already the global batch's mean) cut into the held shards."""
        n, out, rest = self.n, [None] * len(self.entries), []
        pos = 0
        for i, g in enumerate(grads):
            k = len(self.shards[i])
            d = self.dims[i]
            if d is None:
                rest.append((pos, g))
            elif self.lockstep:
                out[pos:pos + k] = collectives.lockstep_reduce_scatter_dim(
                    [g], d, n, kind="fsdp_grad")
            else:
                out[pos] = collectives.reduce_scatter_dim(g, d, group=self.group,
                                                          kind="fsdp_grad").div_(n)
            pos += k
        if rest and not self.lockstep and self.n > 1:
            flat = torch.cat([g.reshape(-1) for _, g in rest])
            collectives.all_reduce_(flat, group=self.group, kind="grad").div_(n)
            rest = [(p, v.view(g.shape)) for (p, g), v in
                    zip(rest, flat.split([g.numel() for _, g in rest]))]
        for p, g in rest:
            out[p] = g.contiguous()
        return out

    def shard_bytes(self, k: int = 0) -> int:
        """The bytes of held rank ``k``'s parameter shards (a replicated
        leaf whole)."""
        return sum(leaf[min(k, len(leaf) - 1)].numel() * leaf[0].element_size()
                   for leaf in self.shards)


def shard_state(state, *, axis=None, lockstep: int = 0, min_size: int = 1024, optimizer=None):
    """``state`` (a fresh :class:`~tpu_dist_torch.train.state.TrainState`)
    under FSDP: its model's parameters sharded over ``axis`` (or a lockstep
    group of ``lockstep`` virtual ranks) by :func:`fsdp_dims`, and the
    optimizer state made over the shards by ``optimizer`` (required: the
    state's own was made over the full leaves)."""
    model = state.params
    n = axis.size if axis is not None else max(1, lockstep)
    tp = getattr(model, "shard_axis", None)
    shards = FSDPShards(model, fsdp_dims(model, n, min_size), axis=axis, lockstep=lockstep,
                        tp=tp)
    return dataclasses.replace(state, fsdp=shards, opt_state=optimizer.init(shards.entries))


def _chunked(images, labels, K: int, n: int):
    """The ``K`` chunks of a batch in JAX's order (``tpu_dist/parallel/
    fsdp.py::chunk``): chunk ``k`` holds each of the ``n`` ranks' ``k``-th
    local sub-batch (``n`` is 1 for a process's own batch)."""
    b = images.shape[0]
    if b % (n * K):
        raise ValueError(f"batch {b} does not split into {K} chunks over {n} ranks")

    def cut(t):
        t = t.reshape((n, K, b // (n * K)) + tuple(t.shape[1:]))
        return t.transpose(0, 1).reshape((K, b // K) + tuple(t.shape[3:]))

    return list(zip(cut(images), cut(labels)))


def make_fsdp_train_step(optimizer, *, grad_accum_steps: int = 1,
                         compute_dtype: torch.dtype = torch.float32,
                         label_smoothing: float = 0.0, grad_clip_norm: float = 0.0,
                         moe_aux_coef: float = 0.01, remat: bool = False,
                         grad_compression: str = "none", model_kwargs: Optional[dict] = None):
    """Build ``step(state, images, labels, lr) -> (state, metrics)``, the
    FSDP twin of :func:`tpu_dist_torch.train.step.make_train_step` over
    ``state.fsdp`` (module docstring). ``images``/``labels`` are this
    rank's share of the global batch, or the whole global batch of a
    lockstep group; the metrics are the plain step's. ``grad_compression``
    other than ``'none'`` raises JAX's ``ValueError``."""
    from tpu_dist_torch.nn import functional as F  # noqa: PLC0415
    from tpu_dist_torch.nn import layers  # noqa: PLC0415
    from tpu_dist_torch.resilience import preemption  # noqa: PLC0415
    from tpu_dist_torch.train import step as step_lib  # noqa: PLC0415
    from tpu_dist_torch.train.optim import LAMB, LARS  # noqa: PLC0415

    if grad_compression != "none":
        raise ValueError(_COMPRESSION_REFUSAL.format(grad_compression))
    K = int(grad_accum_steps)
    if K < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    norm_kw = isinstance(optimizer, (LARS, LAMB))  # per-layer norms over the shards

    def step(state, images, labels, lr):
        fs, model = state.fsdp, state.params
        if fs is None:
            raise ValueError("the FSDP step needs state.fsdp (parallel.fsdp.shard_state)")
        dev = next(model.parameters()).device
        images, labels = step_lib._to(images, dev), step_lib._to(labels, dev)
        # SyncBN over the data group: the global batch's statistics (a
        # lockstep group's one forward sees the global batch already)
        fwd_kw = ({"group": fs.group if fs.group is not None else collectives.sync_group(True)}
                  if state.bn_state and not fs.lockstep else {})
        fwd_kw.update(model_kwargs or {})
        params = fs.params
        model.train()

        def forward_loss(x, y):
            out = model(x.to(compute_dtype), **fwd_kw)
            aux = None
            if isinstance(out, tuple):  # the MoE ViT's load-balancing loss
                out, aux = out
            loss = F.cross_entropy(out, y, label_smoothing=label_smoothing)
            if aux is not None:
                loss = loss + moe_aux_coef * aux.to(loss.dtype)
            return loss, out

        grads, losses, hits = None, [], []
        with fs.gathered():
            for x, y in _chunked(images, labels, K, fs.n if fs.lockstep else 1):
                with torch.enable_grad():
                    if remat:
                        loss, out = torch.utils.checkpoint.checkpoint(
                            forward_loss, x, y, use_reentrant=False, preserve_rng_state=False,
                            context_fn=lambda: (contextlib.nullcontext(),
                                                layers.running_stats_frozen(model)))
                    else:
                        loss, out = forward_loss(x, y)
                    g = torch.autograd.grad(loss, params)
                grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
                losses.append(loss.detach())
                hits.append(F.topk_correct(out.detach().float(), y, (1, 5)))
        if K > 1:
            grads = [g / K for g in grads]
        loss = torch.stack(losses).mean() if K > 1 else losses[0]
        applied = fs.reduce_grads(grads)
        if grad_clip_norm > 0.0:
            sq = fs.global_square_norm(applied)
            scale = torch.clamp(grad_clip_norm / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0)
            applied = [g * scale for g in applied]
        kw = {"leaf_norms": fs.leaf_norms} if norm_kw else {}
        optimizer.update(applied, state.opt_state, fs.entries, lr, **kw)
        c1 = sum(h[0] for h in hits)
        c5 = sum(h[1] for h in hits)
        # the 4th sum carries this rank's SIGTERM flag (train/step.py)
        sums = [loss.float(), c1.float(), c5.float(),
                # tpu-dist: ignore[TD001] — the host SIGTERM flag, no tensor
                torch.full((), float(preemption.requested()), device=loss.device)]
        reduced = collectives.all_reduce_(torch.stack(sums), kind="metrics")
        metrics = step_lib.metrics_from_sums(reduced, len(labels))
        metrics["preempt"] = reduced[3]
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step


def make_fsdp_eval_step(*, compute_dtype: torch.dtype = torch.float32, tp_axis=None, axis=None):
    """The FSDP twin of :func:`tpu_dist_torch.train.step.make_eval_step`
    (the same masked global sums): the parameters gathered for the
    forward and released after it. ``tp_axis``/``axis`` as there (FSDP×TP
    sums over the data axis)."""
    from tpu_dist_torch.train import step as step_lib  # noqa: PLC0415

    inner = step_lib.make_eval_step(compute_dtype=compute_dtype, tp_axis=tp_axis, axis=axis)

    def eval_step(state, images, labels, mask):
        with state.fsdp.gathered():
            return inner(state, images, labels, mask)

    return eval_step
