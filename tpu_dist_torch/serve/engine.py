"""The inference path: continuous batching over one eager forward, per-request
latency split into phases, checkpoint -> serving weights, int8 weights,
SLO rules, history, exposition and heartbeat. Counterpart of
``tpu_dist/serve/engine.py``.

* Batches are padded to a power-of-two bucket (``1, 2, 4, ...,
  max_batch``), as in the JAX engine, and :meth:`ServingEngine.warmup`
  runs every bucket once with host numpy zeros, the same path the pump
  takes.
* Every request's life is split into the ``slo.PHASES`` on the engine's
  injectable clock. On CUDA, ``dispatch`` is the host time to copy the
  batch to the card and enqueue the forward, ``device`` ends at
  ``torch.cuda.synchronize()`` (the JAX engine's ``block_until_ready``),
  and ``fetch`` is the copy back to numpy. On the CPU the forward runs
  inside ``dispatch`` and ``device`` is ~0.
* :func:`load_serving_state` walks a checkpoint directory newest to
  oldest (a corrupt candidate is quarantined) and restores through the
  elastic :class:`~tpu_dist_torch.elastic.remap.Remapper`, so a ZeRO-1
  checkpoint written at any data-parallel extent loads; it returns host
  numpy in the JAX layout, as the JAX function does, and reads the JAX
  package's checkpoints and the port's alike.
* ``quantize=True`` keeps the weights on the device as int8 plus one f32
  scale per 256 elements (:class:`Int8Weights`), quantized in the JAX
  layout so every leaf's ``q`` and ``scale`` equal the JAX engine's bit
  for bit, and dequantizes them in one launch a forward; the module runs
  on them through ``torch.func.functional_call``.
* :meth:`ServingEngine.record_window` evaluates the SLO rules, writes the
  ``serve`` and ``alert`` history records and refreshes the exporter's
  exposition; :meth:`ServingEngine.pump` beats the heartbeat.

The JAX engine's ``CompileWatcher`` retrace accounting has no
counterpart: eager PyTorch compiles nothing per shape, so the port counts
no retrace. Its ``serve`` record therefore never carries ``retraces``
(the JAX engine writes it only when nonzero), and the builtin
``serve_retrace`` rule on ``compile.retraces`` loads and never fires.
"""

from __future__ import annotations

import collections
import os
import re
import time
import zipfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu_dist_torch import bridge, resolve_device
from tpu_dist_torch import ckpt as ckpt_lib
from tpu_dist_torch.comm import quantize as q_lib
from tpu_dist_torch.elastic import remap as remap_lib
from tpu_dist_torch.obs import counters as counters_lib
from tpu_dist_torch.obs import heartbeat as heartbeat_lib
from tpu_dist_torch.obs import spans as spans_lib
from tpu_dist_torch.serve import slo as slo_lib


def batch_buckets(max_batch: int) -> Tuple[int, ...]:
    """The power-of-two bucket ladder ``(1, 2, 4, ..., max_batch)``;
    ``max_batch`` must itself be a power of two."""
    if max_batch < 1 or max_batch & (max_batch - 1):
        raise ValueError(
            f"max_batch must be a power of two (the bucket ladder), "
            f"got {max_batch}"
        )
    out = []
    b = 1
    while b <= max_batch:
        out.append(b)
        b *= 2
    return tuple(out)


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket holding ``n`` requests."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the top bucket {buckets[-1]}")


class Request:
    """One in-flight inference request. ``arrival_s`` is on the engine's
    clock; the pump fills in the result and the phase timings."""

    __slots__ = (
        "id", "payload", "arrival_s", "result", "ok",
        "total_s", "ttfb_s", "phase_s",
    )

    def __init__(self, id, payload: np.ndarray, arrival_s: float):
        self.id = id
        self.payload = payload
        self.arrival_s = arrival_s
        self.result: Optional[np.ndarray] = None
        self.ok = False
        self.total_s: Optional[float] = None
        self.ttfb_s: Optional[float] = None
        self.phase_s: Dict[str, float] = {}


# -- int8 weight quantization ------------------------------------------------


def _tree_map(fn, tree):
    """``fn`` over the leaves of a pytree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def quantize_weights(params, chunk: Optional[int] = None):
    """Per-leaf int8 quantization of a JAX-layout parameter pytree (numpy
    or torch leaves): each leaf is raveled in its layout and quantized per
    ``chunk`` (``comm/quantize.py``, round to nearest: serving must be
    reproducible). Returns ``(qtree, shapes)``: the pytree with ``{"q":
    int8 (m,), "scale": f32 (k,)}`` leaves, and the leaves' shapes."""
    chunk = chunk or q_lib.DEFAULT_CHUNK

    def one(leaf):
        flat = torch.as_tensor(np.asarray(leaf) if not torch.is_tensor(leaf) else leaf)
        q, scales = q_lib.quantize_int8(flat.reshape(-1), chunk=chunk)
        return {"q": q, "scale": scales}

    shapes = _tree_map(lambda leaf: tuple(int(d) for d in leaf.shape), params)
    return _tree_map(one, params), shapes


def dequantize_weights(qparams, shapes, chunk: Optional[int] = None):
    """Inverse of :func:`quantize_weights`: the f32 pytree in the JAX
    layout."""
    chunk = chunk or q_lib.DEFAULT_CHUNK
    is_q = lambda x: isinstance(x, dict) and set(x) == {"q", "scale"}  # noqa: E731

    def walk(q, shape):
        if is_q(q):
            return q_lib.dequantize_int8(q["q"], q["scale"], chunk=chunk).reshape(shape)
        if isinstance(q, dict):
            return {k: walk(q[k], shape[k]) for k in q}
        return type(q)(walk(a, b) for a, b in zip(q, shape))

    return walk(qparams, shapes)


def _to_jax(t: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    """A parameter as a view in the JAX layout: a Linear weight [out, in]
    as [in, out], a conv weight OIHW as HWIO."""
    if kind == "linear":
        return t.t()
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    return t


def _from_jax(t: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    """The inverse view of :func:`_to_jax`."""
    if kind == "linear":
        return t.t()
    if kind == "conv":
        return t.permute(3, 2, 0, 1)
    return t


class Int8Weights:
    """A module's parameters at rest on ``device`` as int8 plus f32 scales.

    Each parameter is quantized in its JAX layout (a Linear weight as [in,
    out], a conv weight as HWIO), so its ``q`` and ``scale``
    (:meth:`leaf`) equal :func:`quantize_weights` of the JAX pytree bit
    for bit. All ``q`` live in one flat int8 buffer, each leaf padded to
    whole chunks with zeros, and all scales in one flat f32 buffer, so
    :meth:`dequantize` is one launch (the int8 * f32 product, element for
    element the JAX dequantize's) and the parameters are views into its
    result, back in the module's layout: one ``as_strided`` each, their
    sizes and strides worked out once here (a forward pays the host for
    one view a parameter)."""

    def __init__(self, module: nn.Module, device, chunk: int = q_lib.DEFAULT_CHUNK):
        self.chunk = chunk
        kinds = {}
        for mname, mod in module.named_modules():
            kind = ("linear" if isinstance(mod, nn.Linear)
                    else "conv" if isinstance(mod, nn.Conv2d) else None)
            if kind:
                kinds[f"{mname}.weight" if mname else "weight"] = kind
        named = list(module.named_parameters())
        n_chunks = sum(-(-p.numel() // chunk) for _, p in named)
        self.q = torch.zeros(n_chunks * chunk, dtype=torch.int8, device=device)
        self.scale = torch.zeros(n_chunks, dtype=torch.float32, device=device)
        # (name, offset, numel, size and stride of the module-layout view)
        self.layout: List[Tuple[str, int, int, Tuple[int, ...], Tuple[int, ...]]] = []
        off = 0
        with torch.no_grad():
            for name, p in named:
                kind = kinds.get(name)
                jax_view = _to_jax(p.detach().to(device=device, dtype=torch.float32), kind)
                q, scales = q_lib.quantize_int8(jax_view.reshape(-1), chunk=chunk)
                self.q[off:off + q.numel()] = q
                self.scale[off // chunk:off // chunk + scales.numel()] = scales
                view = _from_jax(torch.empty(jax_view.shape, device="meta"), kind)
                self.layout.append((name, off, q.numel(), tuple(view.shape), view.stride()))
                off += scales.numel() * chunk

    @property
    def nbytes(self) -> int:
        """Bytes at rest: the int8 buffer and the scales."""
        return self.q.numel() + 4 * self.scale.numel()

    def leaf(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(q, scale)`` of one parameter, in the JAX layout's ravel."""
        for n, off, m, _, _ in self.layout:
            if n == name:
                return (self.q[off:off + m],
                        self.scale[off // self.chunk:off // self.chunk - (-m // self.chunk)])
        raise KeyError(name)

    def dequantize(self) -> Dict[str, torch.Tensor]:
        """Every parameter in f32, as views of one fresh buffer in the
        module's layout (``{parameter name: tensor}``)."""
        flat = (self.q.view(-1, self.chunk) * self.scale[:, None]).view(-1)
        return {name: flat.as_strided(size, stride, off)
                for name, off, _, size, stride in self.layout}


# -- checkpoint -> serving weights ---------------------------------------------

_KEY_SEG = re.compile(r"\['([^']*)'\]|\[(\d+)\]")
_OPT = "['opt_state']"


def _tree_from_keys(entries: Dict[str, object]):
    """Rebuild a nested dict/list pytree from keystr keys (``['a'][0]['b']``)
    -> leaves; None when a key uses another construct (the caller then
    leaves that subtree out of the template)."""
    root: dict = {}
    for key, leaf in entries.items():
        segs = []
        pos = 0
        for m in _KEY_SEG.finditer(key):
            if m.start() != pos:
                return None
            segs.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
            pos = m.end()
        if pos != len(key) or not segs:
            return None
        node = root
        for i, seg in enumerate(segs):
            last = i == len(segs) - 1
            node = node.setdefault(seg, leaf if last else {})

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in sorted(out)]
        return out

    return listify(root)


def _like(shape, dtype) -> np.ndarray:
    """A template leaf: the shape and dtype, no memory."""
    return np.broadcast_to(np.zeros((), dtype), tuple(shape))


def _opt_entries(path: str) -> Dict[str, np.ndarray]:
    """The checkpoint's optimizer entries as template leaves, keyed by the
    key's rest after ``['opt_state']``, read from their ``.npy`` headers
    (no array data is decompressed)."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            key = name[:-4] if name.endswith(".npy") else name
            if not key.startswith(_OPT):
                continue
            with zf.open(name) as f:
                version = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                shape, _, dtype = read(f)
            out[key[len(_OPT):]] = _like(shape, dtype)
    return out


def load_serving_state(ckpt: str, model: nn.Module, *, verify: bool = True) -> dict:
    """Checkpoint -> serving weights, through the restore ladder.

    ``ckpt`` is a plain-format checkpoint file or a checkpoint directory,
    walked newest to oldest: an unreadable or CRC-failing candidate is
    moved to ``*.corrupt`` and the next older one tried. ``model`` (a
    ResNet or a ViT module) gives the template: every parameter's and BN
    statistic's shape, in the JAX layout.

    The template's optimizer entries mirror the checkpoint's, with a
    ZeRO-1 flat vector of ``padded_len(L, dp)`` (``dp`` from the
    ``elastic`` stamp) re-laid at the serving extent of 1, so the restore
    runs through the elastic remapper as an elastic resume does and a
    checkpoint written at any extent loads bit for bit. The optimizer
    state is then dropped.

    Returns ``{"params", "bn_state", "step", "epoch", "meta", "path",
    "remapped"}``: JAX-layout host numpy pytrees (load them into a module
    with :func:`tpu_dist_torch.bridge.load_jax_params`), and the
    ``(key, kind)`` pairs the remapper rebuilt. Raises when nothing in
    ``ckpt`` is usable, on a checkpoint of another model
    (:class:`~tpu_dist_torch.elastic.errors.ConfigMismatchError` or
    ``KeyError``) and on a directory of sharded checkpoints."""
    params, bn_state = bridge.jax_layout_template(model)
    L = remap_lib.params_len(params)

    if os.path.isdir(ckpt):
        candidates = ckpt_lib.all_checkpoints(ckpt)
        if not candidates:
            if ckpt_lib.latest_sharded_checkpoint(ckpt):  # JAX's engine refuses it too
                raise ValueError(
                    f"{ckpt} holds sharded-format checkpoints; serving "
                    "loads the plain format — write one with the plain "
                    "saver (--sharded_ckpt off) or convert offline"
                )
            raise FileNotFoundError(f"no checkpoints in {ckpt}")
    else:
        candidates = [(ckpt, -1)]

    read_errors = (ckpt_lib.CheckpointCorruptError,) + ckpt_lib.CKPT_READ_ERRORS
    last_err: Optional[Exception] = None
    for path, epoch in candidates:
        try:
            meta = ckpt_lib.read_meta(path)
            opt_entries = _opt_entries(path)
        except read_errors as e:
            last_err = e
            if len(candidates) > 1:
                ckpt_lib.quarantine(path)
                continue
            raise
        n_old = ((meta or {}).get("elastic") or {}).get("dp")
        opt_tpl = None
        if opt_entries:
            mirrored = {}
            for k, leaf in opt_entries.items():
                if (leaf.ndim == 1 and isinstance(n_old, int) and n_old > 0
                        and leaf.size == q_lib.padded_len(L, n_old)):
                    mirrored[k] = _like((q_lib.padded_len(L, 1),), leaf.dtype)
                else:
                    mirrored[k] = leaf
            if "" in mirrored:  # the whole optimizer state is one flat leaf
                opt_tpl = mirrored[""] if len(mirrored) == 1 else None
            else:
                opt_tpl = _tree_from_keys(mirrored)
        template = bridge.keystr_leaves({
            "params": params,
            "bn_state": bn_state,
            # an unparseable subtree degrades to (): the restore then
            # drops the checkpoint's optimizer entries
            "opt_state": opt_tpl if opt_tpl is not None else (),
            "step": np.zeros((), np.int32),
        })
        remapper = remap_lib.make_remapper(params, meta, 1)
        try:
            with spans_lib.span("serve/load_weights", file=os.path.basename(path)):
                restored = ckpt_lib.restore(path, verify=verify, template=template,
                                            remap=remapper)
        except read_errors as e:
            last_err = e
            if len(candidates) > 1:
                ckpt_lib.quarantine(path)
                continue
            raise
        counters_lib.inc("serve.weights_loaded")
        if remapper.used:
            counters_lib.inc("serve.weights_remapped")
        tree = bridge.keystr_unflatten({
            k: v for k, v in restored.items() if k.startswith(("['params']", "['bn_state']"))})
        return {
            "params": tree["params"],
            "bn_state": tree.get("bn_state", {}),
            "step": int(restored["['step']"]),
            "epoch": meta.get("epoch", epoch),
            "meta": meta,
            "path": path,
            "remapped": list(remapper.used),
        }
    raise ValueError(
        f"every checkpoint candidate in {ckpt} was unreadable/corrupt "
        f"(last error: {last_err})"
    )


# -- the engine ----------------------------------------------------------------


class ServingEngine:
    """Continuous-batching inference over ``model`` (an ``nn.Module``
    mapping a float batch ``[B, ...]`` to logits ``[B, classes]``).

    Single-threaded: callers :meth:`submit` requests and drive
    :meth:`pump`, which runs the longest-waiting requests as one
    bucket-padded batch and completes them with their phase latencies.
    :meth:`record_window` closes an observation window: the ``serve.*``
    scalars as gauges, the SLO rules evaluated, a ``serve`` history record
    and the exposition refreshed. ``clock`` is any ``() -> float``
    monotonic source (default ``time.perf_counter``).

    * ``quantize=True``: the weights live on ``device`` as
      :class:`Int8Weights` (``self.int8``); the module itself is moved to
      the CPU, so no f32 copy of its parameters stays on the card, and
      its buffers (BN statistics) are copied to ``device`` in f32.
      Otherwise the module is moved to ``device`` and run as it is.
    * ``slo_rules``: a list of :class:`~tpu_dist_torch.obs.alerts.AlertRule`
      or a spec (``"default"`` or a ``.toml``/``.json`` path,
      :func:`~tpu_dist_torch.serve.slo.load_slo_rules`).
    * ``history``: a :class:`~tpu_dist_torch.metrics.history.MetricsHistory`;
      ``exporter``: a :class:`~tpu_dist_torch.obs.export.MetricsExporter`;
      ``heartbeat_file``: the base path of the per-rank heartbeat
      (``rank`` picks the file), beaten on every pump and removed by
      :meth:`sweep_heartbeat`."""

    def __init__(
        self,
        model: nn.Module,
        *,
        max_batch: int = 8,
        quantize: bool = False,
        deadline_s: Optional[float] = None,
        slo_rules=None,
        history=None,
        exporter=None,
        clock: Optional[Callable[[], float]] = None,
        heartbeat_file: Optional[str] = None,
        rank: int = 0,
        max_queue: Optional[int] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.buckets = batch_buckets(max_batch)
        self.max_batch = max_batch
        self._clock = clock or time.perf_counter
        self._queue: collections.deque = collections.deque()
        self.stats = slo_lib.ServeStats(deadline_s=deadline_s)
        self._heartbeat = (
            heartbeat_lib.Heartbeat(heartbeat_lib.per_rank_path(heartbeat_file, rank))
            if heartbeat_file else None
        )
        self._pumps = 0
        # admission control: while shedding, or at the queue cap, submit()
        # refuses instead of queueing
        self.max_queue = max_queue
        self._shedding = False
        self._shed_reason = ""
        self.history = history
        self.exporter = exporter
        if isinstance(slo_rules, str):
            slo_rules = slo_lib.load_slo_rules(slo_rules)
        self._slo = slo_lib.make_slo_engine(slo_rules) if slo_rules else None
        self._seq = 0
        self._window_start = self._clock()
        self._window_completed_at = 0  # stats.completed at window open
        self.quantized = bool(quantize)
        if quantize:
            model.eval()
            self.int8 = Int8Weights(model, self.device)
            self.model = model.cpu()
            self._buffers = {n: b.to(self.device) for n, b in model.named_buffers()}
        else:
            self.int8 = None
            self.model = model.to(self.device).eval()
        counters_lib.set_gauge("serve.max_batch", max_batch)
        counters_lib.set_gauge("serve.quantized", "int8" if quantize else "none")
        counters_lib.set_gauge("serve.device", str(self.device))

    # -- the forward, in its phases ------------------------------------------

    def _dispatch(self, batch: np.ndarray) -> torch.Tensor:
        """Copy a host batch to the device and enqueue the forward (after
        the int8 weights' dequantize, in int8 mode)."""
        counters_lib.inc("serve.forwards")
        x = torch.from_numpy(batch).to(self.device)
        if self.int8 is None:
            return self.model(x)
        tensors = {**self.int8.dequantize(), **self._buffers}
        return torch.func.functional_call(self.model, tensors, (x,), strict=True)

    def _wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- lifecycle ----------------------------------------------------------

    def warmup(self, sample_shape: Tuple[int, ...]) -> int:
        """Run every bucket once with host numpy zeros, the same path the
        pump takes (lazy CUDA set-up, kernel builds and allocator growth
        land here, not on the first requests). ``sample_shape`` is one
        request's payload shape, e.g. ``(H, W, C)``, in float32. Returns
        the number of buckets run."""
        t0 = self._clock()
        with torch.inference_mode():
            for b in self.buckets:
                self._dispatch(np.zeros((b,) + tuple(sample_shape), np.float32))
                self._wait()
        dur = self._clock() - t0
        spans_lib.add_event("serve/warmup", t0, dur, buckets=len(self.buckets))
        counters_lib.set_gauge("serve.warmup_s", round(dur, 3))
        counters_lib.inc("serve.warmup_forwards", len(self.buckets))
        return len(self.buckets)

    # -- request flow -------------------------------------------------------

    def set_shedding(self, on: bool, reason: str = "") -> None:
        """Toggle load shedding: while on, :meth:`submit` refuses new
        requests and the pump keeps draining what was admitted. ``reason``
        says why (kept while on)."""
        self._shedding = bool(on)
        self._shed_reason = reason if on else ""
        counters_lib.set_gauge("serve.shedding", 1 if on else 0)

    @property
    def shedding(self) -> bool:
        return self._shedding

    def submit(self, payload: np.ndarray, *, id=None,
               arrival_s: Optional[float] = None) -> Request:
        """Enqueue one request (``payload`` is one sample, no batch dim;
        ``arrival_s`` overrides the clock reading).

        While shedding, or with ``max_queue`` requests already queued, the
        request is refused: returned at once with ``ok`` False, counted as
        ``serve.shed``, kept out of the queue and the latency histograms."""
        self._seq += 1
        req = Request(
            id if id is not None else self._seq,
            np.asarray(payload),
            self._clock() if arrival_s is None else arrival_s,
        )
        if self._shedding or (
            self.max_queue is not None and len(self._queue) >= self.max_queue
        ):
            self.stats.on_shed(len(self._queue))
            counters_lib.inc("serve.shed")
            return req
        self._queue.append(req)
        self.stats.on_submit(len(self._queue))
        counters_lib.inc("serve.requests")
        return req

    def queue_depth(self) -> int:
        return len(self._queue)

    @torch.inference_mode()
    def pump(self) -> List[Request]:
        """Assemble and run one batch from the queue head (an empty queue
        is a no-op, but the heartbeat still beats: an idle replica is
        alive). Returns the completed requests."""
        self._pumps += 1
        if self._heartbeat is not None:
            self._heartbeat.beat(step=self._pumps, phase="serve")
        if not self._queue:
            return []
        t_assemble = self._clock()
        take = min(len(self._queue), self.max_batch)
        reqs = [self._queue.popleft() for _ in range(take)]
        bucket = bucket_for(take, self.buckets)
        batch = np.zeros((bucket,) + reqs[0].payload.shape,
                         reqs[0].payload.dtype)
        for i, r in enumerate(reqs):
            batch[i] = r.payload
        self.stats.on_batch(take, bucket)
        self.stats.set_queue_depth(len(self._queue))
        counters_lib.inc("serve.batches")
        counters_lib.inc("serve.batch_requests", take)

        t_dispatch = self._clock()
        out = self._dispatch(batch)
        t_dispatched = self._clock()
        self._wait()
        t_device = self._clock()
        logits = out.cpu().numpy()
        t_fetch = self._clock()

        spans_lib.add_event("serve/batch_assembly", t_assemble,
                            t_dispatch - t_assemble, n=take, bucket=bucket)
        spans_lib.add_event("serve/dispatch", t_dispatch,
                            t_dispatched - t_dispatch)
        spans_lib.add_event("serve/device", t_dispatched,
                            t_device - t_dispatched)
        spans_lib.add_event("serve/fetch", t_device, t_fetch - t_device)

        for i, r in enumerate(reqs):
            r.result = logits[i]
            r.ok = True
            # a future-dated arrival clamps to the assembly instant for
            # every phase alike, so the phases still partition the total
            arrival = min(r.arrival_s, t_assemble)
            r.phase_s = {
                "queue_wait": t_assemble - arrival,
                "batch_assembly": t_dispatch - t_assemble,
                "dispatch": t_dispatched - t_dispatch,
                "device": t_device - t_dispatched,
                "fetch": t_fetch - t_device,
            }
            r.total_s = t_fetch - arrival
            # TTFB: arrival -> the device accepted the work
            r.ttfb_s = t_dispatched - arrival
            self.stats.on_request_done(r.total_s, r.ttfb_s, r.phase_s)
        counters_lib.inc("serve.completed", take)
        return reqs

    def drain(self, max_pumps: int = 10_000) -> List[Request]:
        """Pump until the queue empties; returns everything completed."""
        done: List[Request] = []
        for _ in range(max_pumps):
            if not self._queue:
                break
            done.extend(self.pump())
        return done

    def sweep_heartbeat(self) -> None:
        """Remove the heartbeat file: the clean-exit signal (an absent beat
        reads as a clean exit, a stale one as a wedge)."""
        if self._heartbeat is not None:
            self._heartbeat.sweep()

    # -- observation windows -------------------------------------------------

    def record_window(self) -> Dict[str, float]:
        """Close one observation window: compute the ``serve.*`` scalars
        (requests/s over this window), publish them as registry gauges,
        evaluate the SLO rules over them and the registry (each fired rule
        an ``alert`` record), append a ``serve`` history record and
        refresh the exporter's exposition, histogram families included.
        Returns the scalars, with ``_fired`` the number of alerts fired."""
        now = self._clock()
        window_s = max(now - self._window_start, 1e-9)
        completed = self.stats.completed - self._window_completed_at
        scalars = self.stats.scalars(
            window_s=window_s, completed_in_window=completed
        )
        self.stats.publish(scalars)
        fired = []
        if self._slo is not None:
            window = dict(scalars)
            window.update({
                k: v for k, v in counters_lib.snapshot().items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            })
            fired = self._slo.observe(window)
            for alert in fired:
                counters_lib.inc("serve.slo_alerts")
                if self.history is not None:
                    self.history.log("alert", **alert)
        if self.history is not None:
            rec = {k.split("serve.", 1)[1]: v for k, v in scalars.items()}
            rec["window_s"] = round(window_s, 6)
            rec["phase_s"] = {
                p: round(h.sum, 6) for p, h in self.stats.phases.items()
            }
            rec["latency_hist"] = self.stats.total.to_dict()
            self.history.log("serve", **rec)
        if self.exporter is not None:
            labeled = (
                {"alert_active": self._slo.active()}
                if self._slo is not None else None
            )
            self.exporter.update(
                counters_lib.snapshot(), labeled,
                histograms=self.stats.histogram_families(), force=True,
            )
        self._window_start = now
        self._window_completed_at = self.stats.completed
        scalars["_fired"] = len(fired)
        return scalars
