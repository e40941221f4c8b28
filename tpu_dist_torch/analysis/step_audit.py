"""Layer 2's core: one step's two collective accountings, the port's
counterpart of ``tpu_dist/analysis/jaxpr_audit.py:1-504`` (the proxy model
``_AuditMLP``, the step setup ``_dp_setup``, ``CollectiveBudget``,
``trace_counts`` and the ring model's wire buckets).

JAX reads two views of a step: the jaxpr (the program as written) and the
optimized HLO (what the partitioner emitted). Eager PyTorch has neither;
the port reads the same two views off one run of the step:

* **Predicted (as written)**: the collectives the step asks for through
  :mod:`tpu_dist_torch.comm.collectives`. While a :class:`StepTrace` is
  open it sits in ``collectives._RECORDER`` and books each call: its kind,
  its counter label, its group's size and the dtype and element count of
  each tensor its wire carries. A call stands where JAX's collective
  equation stands (the port fuses a gradient tree into one flat buffer,
  so its counts are smaller than JAX's).
* **Executed (as dispatched)**: the ``c10d`` ops that reach the
  dispatcher, seen by the same :class:`StepTrace` as a
  ``TorchDispatchMode``. Each gives its tensors and its process group. An
  op issued inside a call carries that call's label (JAX's ``op_name``
  metadata); one issued by a raw ``torch.distributed`` call carries none.

Both are priced by one ring model (:data:`KIND_LEGS`): an all-reduce is a
reduce-scatter plus an all-gather of its operand (2 legs), an all-gather
moves its output once, a reduce-scatter, an all-to-all and a send their
input once. :func:`wire_buckets` splits the bytes into payload (integer
legs always; float legs within a factor 8 of the step's largest message)
and sideband (quantization scales, scalar metric reduces), as JAX's
``_wire_buckets`` does.

The dispatch trace also gives the port's schedule metric (JAX reads it
off the HLO text, ``overlap.py:91-147``): for each executed collective,
the number of ops dispatched between it and the first op that reads what
it wrote, or to the end of the step (:meth:`StepTrace.schedule_distances`).

The mode passes every op through unchanged: a step runs under it as it
runs without it (the fused SGD kernel, which the dispatcher never sees,
included). Nothing here imports JAX.

**The step fingerprint** (:meth:`StepTrace.fingerprint`,
:func:`step_fingerprint`) is the port's ``str(jax.make_jaxpr(step)(*args))``:
one canonical string for one call of a step. In dispatch order it holds
every non-view aten op's overload, each tensor argument's and result's
dtype, shape and device type, non-tensor arguments by value, and every
``c10d`` op with its kind and group size; then the delta of each
hand-written kernel's launch counter over the call
(``train/epoch.py::_LAUNCH_COUNTS``: ``fused_sgd.launches`` and the flash
kernels'), since those launch behind the dispatcher, and of each ``comm.*``
counter (a captured graph's replays move them). It never holds tensor
values, data pointers, storage ids or wall time. Two fresh setups of the
same step give the same string; a no-op probe
(:mod:`~tpu_dist_torch.analysis.noop_probes`) compares the fingerprint of
a fresh setup's first call with a kit disarmed and again with it armed.

**The audit cases** (JAX's ``jaxpr_audit.py:50-504`` and ``:2084-2126``):
:func:`register_audit_case` builders return ``(fn, args,
CollectiveBudget)``; :func:`audit_case` runs ``fn(*args)`` once inside a
:class:`StepTrace` and :func:`_compare` holds the counts to the budget:

* **TD101**: the calls through ``comm/collectives.py`` by primitive, exact.
  The port fuses a gradient tree into one flat buffer and its metric sums
  into one all-reduce, so its budgets are its own, written from its step
  code (each beside JAX's, which count jaxpr equations).
* **TD102**: ops that cross the host-device line inside the step: a
  ``_local_scalar_dense`` (``.item()``, ``float()`` of a tensor), and a
  ``_to_copy``/``copy_`` between device types. Budget 0.
* **TD103**: bf16 -> f32 ``_to_copy`` casts against the number the bf16
  compute policy declares.
* **TD104** (:func:`wire_ratio_violations`): the int8 wires' gradient
  payload bytes at most 0.5x the bf16 wire's and 0.25x the f32 wire's.

A fused case (:func:`_fused_setup`) runs one epoch of 2 steps through
``train/epoch.py::make_fused_epoch``, so its budget is twice its step's. A
step captured in a CUDA graph dispatches once, at capture, and runs at
each replay, where nothing reaches Python but the counters the epoch
keeps: it adds the capture's ``comm.*`` increments once a replay. The
trace books a call made under a capture as the graph's, and when it
closes it books the graph's calls once for each replay those counters
show, as JAX multiplies a ``scan`` body by its trips. A replay of a graph
captured before the trace opened books nothing and raises instead. The
dispatch-side counts (the executed ops, TD102's transfers, TD103's casts,
the fingerprint's op lines) see a captured step once, at its capture; the
fingerprint ends with the ``comm.*`` counters' deltas, which count every
replay. At 2 steps an epoch the CUDA epoch runs both steps eagerly on its
side stream (``WARMUP_STEPS`` is 3) and captures nothing.
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_dist_torch import resolve_device
from tpu_dist_torch.analysis.rules import Violation
from tpu_dist_torch.comm import collectives
from tpu_dist_torch.comm.compat import TorchDispatchMode
from tpu_dist_torch.obs import counters

#: Per-replica wire legs of each kind under the ring model (JAX's
#: ``KIND_LEGS``): the common (n-1)/n send fraction is left out, so these
#: are relative budgets, not bandwidth estimates.
KIND_LEGS = {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1, "all-to-all": 1,
             "collective-permute": 1}

#: The JAX primitive each kind stands for (the keys of JAX's
#: ``trace_counts()["collectives"]``).
KIND_TO_PRIM = {"all-reduce": "psum", "all-gather": "all_gather",
                "reduce-scatter": "reduce_scatter", "all-to-all": "all_to_all",
                "collective-permute": "ppermute"}

# The counter labels of the collectives.py calls that go through the
# recorder (comm.gather.* does not; a lockstep group's forms count under
# these labels with no call, and no audit traces one).
_RECORDED_LABELS = ("all_reduce.", "reduce_scatter.", "all_to_all.", "all_gather.", "ppermute.")

# Float collectives at or above this element count are payload when the
# step has nothing larger to cut against (JAX's _PAYLOAD_MIN_ELEMS).
_PAYLOAD_MIN_ELEMS = 32

#: c10d op -> (kind, the argument the wire carries, the argument it
#: writes or None). The list forms (``allgather_``, ``alltoall_``) and the
#: coalesced forms carry lists of tensors.
C10D_OPS = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "_allgather_base_": ("all-gather", 0, 0),
    "allgather_": ("all-gather", 0, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "send": ("collective-permute", 0, None),
}
# c10d ops that are no collective of their own: the receiving half of a
# permute (its send is costed) and the host fences
C10D_SKIPPED = frozenset(("recv_", "recv_any_source_", "barrier", "monitored_barrier_"))

_HLO_DTYPES = {
    torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16", torch.float64: "f64",
    torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16", torch.int32: "s32",
    torch.int64: "s64", torch.bool: "pred", torch.complex64: "c64",
}


def hlo_dtype(dtype: torch.dtype) -> str:
    """The HLO name of a torch dtype (``f32``, ``bf16``, ``s8``...), as
    JAX's reports spell dtypes."""
    return _HLO_DTYPES.get(dtype, str(dtype).replace("torch.", ""))


def _is_float(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _storages(tree) -> set:
    out = set()
    for t in _tensors(tree):
        try:
            out.add(t.untyped_storage().data_ptr())
        except (RuntimeError, NotImplementedError):  # a tensor with no storage
            continue
    return out


@dataclasses.dataclass
class CollectiveBudget:
    """Expected collective counts of one step under one parallelism config
    (JAX's ``CollectiveBudget``): ``collectives`` maps a primitive's name
    (:data:`KIND_TO_PRIM`) to its exact count of calls, ``transfers`` the
    host-device copies allowed, ``bf16_to_f32`` the declared bf16 -> f32
    casts (None: not checked)."""

    collectives: dict
    transfers: int = 0
    bf16_to_f32: Optional[int] = None


@dataclasses.dataclass
class Collective:
    """One executed collective, priced with the ring model: the fields of
    JAX's ``shardlint.HLOCollective``. ``op_name`` is the c10d op,
    ``source`` the label of the call that issued it (``""`` for a raw
    ``torch.distributed`` call), ``replica_groups`` the group's ranks."""

    kind: str
    shape: str
    dtype: str
    elems: int
    wire_bytes: int
    int_bytes: int
    float_bytes: int
    replica_groups: Optional[str]
    channel_id: Optional[int]
    op_name: str
    source: str
    computation: str = "step"
    in_loop: bool = False
    loop_trips: int = 1

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _group_ranks(args) -> Optional[str]:
    """The ranks of the process group among a c10d op's arguments, as
    JAX's replica groups print (``{{0,1,2,3}}``)."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                ranks = dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
            except (RuntimeError, ValueError, AttributeError):
                return None
            return "{{" + ",".join(str(r) for r in ranks) + "}}"
    return None


def price(kind: str, tensors) -> dict:
    """The ring model of one collective over ``tensors`` (those its wire
    carries): elements, wire bytes and their integer and float shares,
    the dominant dtype and the shape string of JAX's inventory."""
    legs = KIND_LEGS.get(kind, 1)
    elems = byts = ints = flts = 0
    parts = []
    for t in tensors:
        n = t.numel()
        b = legs * n * t.element_size()
        elems += n
        byts += b
        if _is_float(t.dtype):
            flts += b
        else:
            ints += b
        parts.append((hlo_dtype(t.dtype), n))
    dom = max(parts, key=lambda p: p[1])[0] if parts else "?"
    shape = (f"{parts[0][0]}[{parts[0][1]}]" if len(parts) == 1
             else "(" + ",".join(f"{d}[{n}]" for d, n in parts) + ")")
    return {"elems": elems, "wire_bytes": byts, "int_bytes": ints, "float_bytes": flts,
            "dtype": dom, "shape": shape}


_ADDRESS = re.compile(r" at 0x[0-9a-fA-F]+")


def _launch_counts() -> list:
    """``[(name, count)]`` of the hand-written kernels' launch counters
    (``train/epoch.py::_LAUNCH_COUNTS``)."""
    from tpu_dist_torch.train import epoch  # noqa: PLC0415 — epoch imports the step

    return [(f"{getattr(holder, '__name__', holder)}.{attr}", getattr(holder, attr, 0))
            for holder, attr in epoch._LAUNCH_COUNTS]


def _describe(x) -> str:
    """One argument or result of an op in the fingerprint: a tensor by its
    dtype, shape and device type, a process group by its size, anything
    else by value (with no address in it)."""
    if isinstance(x, torch.Tensor):
        return f"{hlo_dtype(x.dtype)}{list(x.shape)}@{x.device.type}"
    if isinstance(x, (list, tuple)):
        inner = ",".join(_describe(v) for v in x)
        return f"[{inner}]" if isinstance(x, list) else f"({inner})"
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}={_describe(v)}" for k, v in sorted(x.items())) + "}"
    if isinstance(x, torch.device):
        return x.type
    if isinstance(x, torch.ScriptObject):
        try:
            return f"group[{dist.ProcessGroup.unbox(x).size()}]"
        except (RuntimeError, ValueError, AttributeError, TypeError):
            return type(x).__name__
    if isinstance(x, (bool, int, float, str, type(None), torch.dtype, torch.layout,
                      torch.memory_format)):
        return repr(x)
    return _ADDRESS.sub("", repr(x))


class StepTrace(TorchDispatchMode):
    """Both accountings of the steps run inside it (module docstring):
    ``calls`` (one dict a collective call: ``kind``, ``label``,
    ``group_size``, ``tensors`` as ``[(dtype, elements)]``), ``ops`` (the
    executed :class:`Collective` list), ``transfers`` (host-device copies
    and host reads), ``bf16_to_f32`` (casts) and the step fingerprint
    (:meth:`fingerprint`). Enter it around the step; it nests in nothing
    of its own kind."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # torch wraps a mode's handler to import torch._dynamo at its first
        # call unless the mode opts out (obs/costmodel.py::_count_mode)
        return False

    def __init__(self):
        super().__init__()
        self.calls: list = []
        self.ops: list = []
        self.transfers = 0
        self.bf16_to_f32 = 0
        self._label: Optional[str] = None
        # the dispatched non-view ops in order: (ops index or None, reads, writes)
        self._seq: list = []
        self._fp: list = []  # the fingerprint's op lines
        self._launch0: list = []
        self._captured: list = []  # the calls made under a CUDA graph's capture
        self._counters0: dict = {}
        self.counted: dict = {}  # the comm.* counters' deltas over the trace

    # -- the predicted side: collectives.py's calls -------------------------

    def issue(self, kind: str, label: str, tensors, group, fn, /, *args, **kwargs):
        """Book one call of :mod:`~tpu_dist_torch.comm.collectives` and make
        it: the c10d ops it dispatches carry ``label``. A call made under a
        CUDA graph's capture is the graph's: it runs at each replay."""
        capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
        (self._captured if capturing else self.calls).append({
            "kind": kind, "label": label, "group_size": collectives.world_size(group),
            "tensors": [(t.dtype, t.numel()) for t in tensors],
        })
        outer, self._label = self._label, label
        try:
            return fn(*args, **kwargs)
        finally:
            self._label = outer

    def __enter__(self):
        if collectives._RECORDER is not None:
            raise RuntimeError("a step is already being traced")
        collectives._RECORDER = self
        self._launch0 = _launch_counts()
        self._counters0 = counters.snapshot()
        try:
            return super().__enter__()
        except BaseException:
            collectives._RECORDER = None
            raise

    def __exit__(self, *exc):
        collectives._RECORDER = None
        out = super().__exit__(*exc)
        self.counted = {k.removeprefix("comm."): v for k, v
                        in counters.delta(self._counters0, counters.snapshot()).items()
                        if k.startswith("comm.")}
        if exc[0] is None:
            self._book_replays()
        return out

    def _book_replays(self) -> None:
        """Book the captured calls once for each replay that the ``comm.*``
        counters show beyond the calls booked as they ran (module
        docstring); raise where those counters show calls of a recorded
        kind that the trace never saw, a graph captured before it opened."""
        booked = Counter(c["label"] for c in self.calls)
        graph = Counter(c["label"] for c in self._captured)
        replays = {(self.counted.get(label, 0) - booked[label]) / n
                   for label, n in graph.items()}
        if len(replays) > 1 or any(r < 0 or r != int(r) for r in replays):
            raise RuntimeError(f"the replays of a captured step disagree: calls "
                               f"{self.counted}, booked {dict(booked)}, a replay {dict(graph)}")
        for _ in range(int(replays.pop()) if replays else 0):
            self.calls.extend(dict(c) for c in self._captured)
        unseen = {label: n - booked[label] for label, n in self.counted.items()
                  if label.startswith(_RECORDED_LABELS) and label not in graph
                  and n > booked[label]}
        if unseen:
            raise RuntimeError(f"collectives ran inside the trace that it did not book, "
                               f"{unseen}: the replays of a CUDA graph captured before the "
                               "trace opened (open it around the capture)")

    # -- the executed side: what reaches the dispatcher ---------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(func, "is_view", False):
            return out  # a view reads no data and writes none
        name = func._overloadpacket.__name__
        index = None
        writes: set = set()
        line = f"{func} {_describe(list(args))} {_describe(kwargs)} -> {_describe(out)}"
        if func.namespace == "c10d":  # the kind first; the group is among the arguments
            line = f"{C10D_OPS.get(name, (f'c10d:{name}',))[0]} {line}"
        self._fp.append(line)
        if func.namespace == "c10d" and name not in C10D_SKIPPED:
            kind, costed, written = C10D_OPS.get(name, (f"c10d:{name}", 0, 0))
            priced = price(kind, _tensors(args[costed]))
            index = len(self.ops)
            self.ops.append(Collective(
                kind=kind, shape=priced["shape"], dtype=priced["dtype"], elems=priced["elems"],
                wire_bytes=priced["wire_bytes"], int_bytes=priced["int_bytes"],
                float_bytes=priced["float_bytes"], replica_groups=_group_ranks(args),
                channel_id=None, op_name=f"c10d.{name}", source=self._label or ""))
            if written is not None:
                writes = _storages(args[written])
        elif name == "_to_copy" and isinstance(out, torch.Tensor) and args:
            src = args[0]
            if src.device.type != out.device.type:
                self.transfers += 1
            if src.dtype == torch.bfloat16 and out.dtype == torch.float32:
                self.bf16_to_f32 += 1
        elif name == "copy_" and len(args) > 1 and isinstance(args[1], torch.Tensor):
            if args[0].device.type != args[1].device.type:
                self.transfers += 1
        elif name == "_local_scalar_dense":
            self.transfers += 1  # a tensor's value read back to the host
        self._seq.append((index, _storages(list(args) + list(kwargs.values())), writes))
        return out

    def _launch_deltas(self) -> list:
        return [(name, now - before) for (name, now), (_, before)
                in zip(_launch_counts(), self._launch0)]

    def fingerprint(self) -> str:
        """The step fingerprint of what ran inside the trace so far (module
        docstring): the op lines, then each kernel's launches since the
        trace was entered, then each ``comm.*`` counter's delta (a graph's
        replays included)."""
        return "\n".join(self._fp + [f"launches {n} +{d}" for n, d in self._launch_deltas()]
                         + [f"calls {k} +{v}" for k, v in sorted(self.counted.items())])

    def launches(self) -> dict:
        """Each hand-written kernel's launches since the trace was entered,
        where any."""
        return {n: d for n, d in self._launch_deltas() if d}

    # -- reading the trace ---------------------------------------------------

    def schedule_distances(self) -> list:
        """For each executed collective, in order: ``{"kind", "op",
        "distance"}``, the number of ops dispatched after it up to the first
        that reads what it wrote (1: the very next op), or to the end of the
        trace when nothing reads it (a send, a result returned unread)."""
        out = []
        for i, (index, _, writes) in enumerate(self._seq):
            if index is None:
                continue
            distance = len(self._seq) - 1 - i
            for j in range(i + 1, len(self._seq)):
                if writes & self._seq[j][1]:
                    distance = j - i
                    break
            out.append({"kind": self.ops[index].kind, "op": index, "distance": distance})
        return out

    def predicted(self) -> dict:
        """The calls priced with the ring model, by kind (JAX's
        ``shardlint.predicted_inventory``): ``eqns`` (here: calls),
        ``elems``, ``bytes`` and ``bytes_f32norm`` (narrow-float legs
        priced at 4 bytes an element), their integer and float shares.
        Elements are leg-free and dtype-independent."""
        by_kind: dict = {}
        for call in self.calls:
            kind = call["kind"]
            legs = KIND_LEGS.get(kind, 1)
            e = by_kind.setdefault(kind, {"eqns": 0, "elems": 0, "bytes": 0, "bytes_f32norm": 0,
                                          "int_bytes": 0, "float_bytes": 0,
                                          "float_bytes_f32norm": 0})
            e["eqns"] += 1
            for dtype, n in call["tensors"]:
                isz = dtype.itemsize
                is_float = _is_float(dtype)
                b = legs * n * isz
                b_norm = legs * n * (max(isz, 4) if is_float else isz)
                e["elems"] += n
                e["bytes"] += b
                e["bytes_f32norm"] += b_norm
                if is_float:
                    e["float_bytes"] += b
                    e["float_bytes_f32norm"] += b_norm
                else:
                    e["int_bytes"] += b
        totals = {k: sum(e[k] for e in by_kind.values())
                  for k in ("elems", "bytes", "bytes_f32norm", "int_bytes", "float_bytes",
                            "float_bytes_f32norm")}
        return {"by_kind": by_kind, "totals": totals, "source": "collective-calls"}

    def call_records(self) -> list:
        """The calls as ``(kind, elements, wire bytes, is_quantized, 1)``,
        :func:`wire_buckets`' records: one a call, as JAX's one an
        equation (an 8-bit wire is quantized payload; integer metric
        counts are not)."""
        out = []
        for call in self.calls:
            legs = KIND_LEGS.get(call["kind"], 1)
            elems = sum(n for _, n in call["tensors"])
            byts = sum(legs * n * d.itemsize for d, n in call["tensors"])
            is_q = bool(call["tensors"]) and all(d.itemsize == 1 for d, _ in call["tensors"])
            out.append((call["kind"], elems, byts, is_q, 1))
        return out


def wire_buckets(records) -> dict:
    """Bucket ``(kind, elems, bytes, is_quant, mult)`` records into payload
    and sideband, JAX's ``_wire_buckets``: quantized records are always
    payload; the others are payload within a factor 8 of the step's largest
    message (so the cut is the same under every wire mode), sideband below
    it (quantization scales, scalar metric reduces). ``by_prim`` sums the
    bytes of each kind."""
    max_e = max((e for _, e, _, _, _ in records), default=0)
    cut = max(max_e / 8.0, float(_PAYLOAD_MIN_ELEMS))
    payload = quant = side = 0
    by_prim: Counter = Counter()
    for prim, elems, byts, is_q, mult in records:
        by_prim[prim] += byts * mult
        if is_q:
            payload += byts * mult
            quant += byts * mult
        elif elems >= cut:
            payload += byts * mult
        else:
            side += byts * mult
    return {"payload_bytes": payload, "quantized_payload_bytes": quant, "sideband_bytes": side,
            "by_prim": dict(sorted(by_prim.items()))}


def traced(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once inside a :class:`StepTrace`;
    returns ``(what fn returned, the trace)``."""
    trace = StepTrace()
    with trace:
        out = fn(*args, **kwargs)
    return out, trace


def trace_counts(fn, *args) -> dict:
    """Run the step ``fn(*args)`` once and tally JAX's audited classes:
    ``collectives`` (calls by primitive name), ``executed`` (c10d ops by
    kind), ``transfers``, ``bf16_to_f32``, the calls' ``wire`` buckets and
    the kernels' ``launches``."""
    return _counts(traced(fn, *args)[1])


# -- the proxy model and the data-parallel step setup -------------------------------


class _AuditMLP(torch.nn.Module):
    """JAX's ``_AuditMLP``: a BN-free two-layer MLP 12 -> 16 -> 16 (480
    parameters, four leaves), the smallest model that drives the whole
    step. 480 divides over 1, 2, 4 and 8 ranks, so the flat wires carry no
    padding. Weights are normal * 0.1 drawn from ``seed``, biases zero;
    :func:`tpu_dist_torch.bridge.load_jax_audit_mlp` loads JAX's
    ``PRNGKey(0)`` ones instead. Each weight is cast to the activations'
    dtype where it is used, as the port's models do."""

    in_dim, width, classes = 12, 16, 16

    def __init__(self, device="cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.fc1 = torch.nn.Linear(self.in_dim, self.width)
        self.fc2 = torch.nn.Linear(self.width, self.classes)
        with torch.no_grad():
            for fc in (self.fc1, self.fc2):
                fc.weight.copy_(torch.randn(fc.weight.shape, generator=gen) * 0.1)
                fc.bias.zero_()
        self.to(resolve_device(device))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        lin = torch.nn.functional.linear
        h = torch.relu(lin(x, self.fc1.weight.to(x.dtype), self.fc1.bias.to(x.dtype)))
        return lin(h, self.fc2.weight.to(x.dtype), self.fc2.bias.to(x.dtype))


def proxy_batch(device) -> tuple:
    """This rank's ``(images, labels)`` of the proxy: 8 NHWC f32 images of
    2x2x3 (8 divides by the accumulation family's K = 4) and int64 labels
    below 16, drawn from the rank."""
    rng = np.random.default_rng([0, collectives.rank()])
    images = torch.from_numpy(rng.standard_normal((8, 2, 2, 3), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, _AuditMLP.classes, 8))
    return images.to(device), labels.to(device)


def _dp_setup(device=None, *, params=None, **step_kwargs) -> tuple:
    """The data-parallel step of one family on the proxy, over the default
    process group (every rank), JAX's ``_dp_setup``: SGD at momentum 0.9
    and weight decay 1e-4 (through the fused kernel on a card), ZeRO-1's
    flat state and the int8_ef residuals where the family asks for them,
    8 examples a rank. ``params``: JAX-layout MLP weights
    (``{"w1", "b1", "w2", "b2"}``, numpy) to load. The step is built
    without the SIGTERM flag, so its metrics all-reduce carries JAX's
    three sums. Returns ``(step, (state, images, labels, lr))``."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.train import step as step_lib  # noqa: PLC0415
    from tpu_dist_torch.train.optim import SGD  # noqa: PLC0415
    from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415

    device = resolve_device(device if device is not None else "cuda")
    model = _AuditMLP(device)
    if params is not None:
        bridge.load_jax_audit_mlp(model, params)
    opt = SGD(momentum=0.9, weight_decay=1e-4, fused=True)
    state = TrainState.create(model, opt)
    zero1 = bool(step_kwargs.get("shard_weight_update"))
    if zero1:
        state.layout = step_lib.flat_layout(model)
        state.opt_state = step_lib.init_sharded_opt_state(model, opt, layout=state.layout)
    if step_kwargs.get("grad_compression") == "int8_ef":
        state.layout = state.layout or step_lib.flat_layout(model)
        state.ef = step_lib.init_ef_state(model, zero1=zero1, layout=state.layout)
    step = step_lib.make_train_step(opt, sync_bn=False, preempt_flag=False, **step_kwargs)
    images, labels = proxy_batch(device)
    return step, (state, images, labels, 0.1)


def step_fingerprint(fn, *args, **kwargs) -> str:
    """The fingerprint of one call ``fn(*args, **kwargs)`` (module
    docstring): the port's ``str(jax.make_jaxpr(fn)(*args))``."""
    return traced(fn, *args, **kwargs)[1].fingerprint()


def _fused_setup(device=None, mode: str = "none") -> tuple:
    """The fused-epoch twin of :func:`_dp_setup` (JAX's ``_fused_setup``):
    the proxy through ``train/epoch.py::make_fused_epoch`` on the
    ``mode`` wire, 4 examples a step and 8 uint8 images a rank on the
    device, so one epoch is 2 steps. Returns ``(epoch_fn, args)``, where
    ``epoch_fn(state, images, labels, lr, epoch)`` runs one epoch."""
    from tpu_dist_torch.train import step as step_lib  # noqa: PLC0415
    from tpu_dist_torch.train.epoch import make_fused_epoch  # noqa: PLC0415
    from tpu_dist_torch.train.optim import SGD  # noqa: PLC0415
    from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415

    device = resolve_device(device if device is not None else "cuda")
    model = _AuditMLP(device)
    opt = SGD(momentum=0.9, weight_decay=1e-4, fused=True)
    state = TrainState.create(model, opt)
    if mode == "int8_ef":
        state.layout = step_lib.flat_layout(model)
        state.ef = step_lib.init_ef_state(model, layout=state.layout)
    epoch = make_fused_epoch(opt, batch_per_device=_FUSED_BATCH, sync_bn=False,
                             compute_dtype=torch.float32, grad_compression=mode)
    rng = np.random.default_rng([1, collectives.rank()])
    images = torch.from_numpy(rng.integers(0, 256, (_FUSED_BATCH * _FUSED_STEPS, 2, 2, 3),
                                           dtype=np.uint8)).to(device)
    labels = torch.from_numpy(rng.integers(0, _AuditMLP.classes, _FUSED_BATCH * _FUSED_STEPS)
                              ).to(device)
    # the static buffers go to the device here, outside the audited call
    # (the normalizer's mean and 1/std: JAX bakes them into its program)
    epoch.prepare(state, images, labels)
    return epoch, (state, images, labels, 0.1, 0)


# -- the audit cases: the data-parallel train-step family ---------------------------


@dataclasses.dataclass
class AuditCase:
    name: str
    # builder(device) -> (step_fn, example_args, CollectiveBudget)
    builder: Callable


_CASES: dict = {}


def register_audit_case(name: str, builder: Callable) -> None:
    _CASES[name] = AuditCase(name, builder)


def registered_cases() -> list:
    return sorted(_CASES)


# The budgets count the calls the step makes through comm/collectives.py
# (the backend-independent side), by JAX's primitive names; JAX's own
# budgets (jaxpr equations) are beside each.
#   psum x2: the flat gradient all-reduce (one buffer for every leaf,
#            train/step.py::_flat_all_reduce_mean) and the metrics
#            all-reduce (loss, top-1 and top-5 sums stacked in one
#            buffer). JAX: psum x4 (the gradient tree and three metrics).
_DP_BUDGET = {"psum": 2}
# ZeRO-1 swaps the gradient all-reduce for one reduce-scatter of the flat
# gradients and one all-gather of the updated flat parameters
# (train/step.py::_ZeroOne.update); the metrics all-reduce remains. JAX:
# {"psum": 3, "reduce_scatter": 1, "all_gather": 1}.
_ZERO1_BUDGET = {"psum": 1, "reduce_scatter": 1, "all_gather": 1}
# The quantized two-stage reduce (train/step.py::quantized_pmean_flat): an
# int8 all-to-all of the codes and one of the f32 scales, then an int8
# all-gather of the codes and one of the scales; the metrics all-reduce
# remains. Error feedback is local arithmetic: int8_ef's budget is int8's.
# JAX: {"psum": 3, "all_to_all": 2, "all_gather": 2}.
_DP_INT8_BUDGET = {"psum": 1, "all_to_all": 2, "all_gather": 2}
# ZeRO-1 quantized: the reduce-scatter is the int8 all-to-all pair, the
# parameter all-gather stays f32. JAX: {"psum": 3, "all_to_all": 2,
# "all_gather": 1}.
_ZERO1_INT8_BUDGET = {"psum": 1, "all_to_all": 2, "all_gather": 1}
# A fused epoch: 2 steps of 4 examples, each the step's calls.
_FUSED_STEPS = 2
_FUSED_BATCH = 4
# bf16 compute declares: one cast a parameter leaf in the backward (the
# weight's .to(bf16) in _AuditMLP.forward, whose gradient comes back to
# f32: 4), the logits into the f32 cross-entropy (nn/functional.py) and
# the logits into the f32 top-k of the metrics; the loss is f32 already.
# JAX's count is the same 6.
_BF16_CONVERTS = 6


def _family_setup(device, family: str) -> tuple:
    from tpu_dist_torch.train.step import family_step_kwargs  # noqa: PLC0415

    return _dp_setup(device, **family_step_kwargs(family))


def _case(family: str, budget: dict, bf16_to_f32: Optional[int] = None):
    def build(device):
        fn, args = _family_setup(device, family)
        return fn, args, CollectiveBudget(dict(budget), bf16_to_f32=bf16_to_f32)

    return build


def _fused_budget(per_step: dict) -> dict:
    return {k: v * _FUSED_STEPS for k, v in per_step.items()}


def _case_fused(mode: str, budget: dict):
    def build(device):
        fn, args = _fused_setup(device, mode)
        return fn, args, CollectiveBudget(_fused_budget(budget), bf16_to_f32=None)

    return build


register_audit_case("dp_sgd", _case("dp_sgd", _DP_BUDGET))
# torch's no_sync contract: K local sub-steps, ONE cross-rank reduce — the
# budget is the K=1 step's
register_audit_case("dp_sgd_accum4", _case("dp_sgd_accum4", _DP_BUDGET))
register_audit_case("dp_bf16", _case("dp_bf16", _DP_BUDGET, _BF16_CONVERTS))
register_audit_case("zero1_sgd", _case("zero1_sgd", _ZERO1_BUDGET))
# the bf16 WIRE (grad_compression='bf16', f32 compute): the 2-byte
# reference of TD104's ratios, not the bf16 compute policy (as in JAX,
# TD103 checks dp_bf16 alone)
register_audit_case("dp_wire_bf16", _case("dp_wire_bf16", _DP_BUDGET))
register_audit_case("dp_int8", _case("dp_int8", _DP_INT8_BUDGET))
register_audit_case("dp_int8_ef", _case("dp_int8_ef", _DP_INT8_BUDGET))
register_audit_case("zero1_int8", _case("zero1_int8", _ZERO1_INT8_BUDGET))
# --device_metrics: the health scalars are local arithmetic on the reduced
# gradients, appended after the metrics all-reduce — the plain step's budget
register_audit_case("dp_device_metrics", _case("dp_device_metrics", _DP_BUDGET))
register_audit_case("fused_none", _case_fused("none", _DP_BUDGET))
register_audit_case("fused_bf16", _case_fused("bf16", _DP_BUDGET))
register_audit_case("fused_int8", _case_fused("int8", _DP_INT8_BUDGET))
register_audit_case("fused_int8_ef", _case_fused("int8_ef", _DP_INT8_BUDGET))


def case_budget(name: str, device=None) -> tuple:
    """``(fn, args, budget)`` of the registered case ``name``, built on
    ``device`` over the default process group."""
    if name not in _CASES:
        raise ValueError(f"unknown audit case {name!r}; registered: {registered_cases()}")
    return _CASES[name].builder(device)


def audit_case(name: str, device=None) -> tuple:
    """Run case ``name`` once inside a :class:`StepTrace`; returns
    ``(counts, violations)``, the counts :func:`trace_counts`'."""
    fn, args, budget = case_budget(name, device)
    counts = trace_counts(fn, *args)
    return counts, _compare(name, counts, budget)


def _counts(trace: StepTrace) -> dict:
    calls = Counter(KIND_TO_PRIM.get(c["kind"], c["kind"]) for c in trace.calls)
    executed = Counter(op.kind for op in trace.ops)
    return {
        "collectives": dict(sorted(calls.items())),
        "executed": dict(sorted(executed.items())),
        "transfers": trace.transfers,
        "bf16_to_f32": trace.bf16_to_f32,
        "wire": wire_buckets(trace.call_records()),
        "launches": trace.launches(),
    }


# TD104: (quantized case, reference case, max payload-byte ratio). Every
# pair present in a report is checked; equality is allowed (the int8 modes
# land on 0.5x bf16 / 0.25x f32 when the flat padding is zero).
_WIRE_RATIO_CHECKS = (
    ("dp_int8", "dp_wire_bf16", 0.5),
    ("dp_int8", "dp_sgd", 0.25),
    ("dp_int8_ef", "dp_wire_bf16", 0.5),
    ("dp_int8_ef", "dp_sgd", 0.25),
    ("fused_int8", "fused_bf16", 0.5),
    ("fused_int8", "fused_none", 0.25),
    ("fused_int8_ef", "fused_bf16", 0.5),
    ("fused_int8_ef", "fused_none", 0.25),
)


def wire_ratio_violations(report: dict) -> list:
    """TD104 over a case -> counts report: a quantized wire's gradient
    payload must honour the declared fraction of its reference mode's."""
    out: list = []
    for qcase, ref, lim in _WIRE_RATIO_CHECKS:
        if qcase not in report or ref not in report:
            continue
        qb = report[qcase]["wire"]["payload_bytes"]
        rb = report[ref]["wire"]["payload_bytes"]
        if rb and qb > lim * rb:
            out.append(Violation(
                "TD104", f"<step:{qcase}>", 0,
                f"gradient-collective payload is {qb} B/step vs {ref}'s {rb} B — exceeds the "
                f"declared {lim}x wire budget of the quantized format (a leg decompressed, or "
                "padding/scale data leaked into the payload)",
                snippet=f"payload:{qb}>{lim}x{rb}"))
    return out


def _compare(name: str, counts: dict, budget: CollectiveBudget) -> list:
    out: list = []
    path = f"<step:{name}>"
    actual = counts["collectives"]
    for prim in sorted(set(actual) | set(budget.collectives)):
        want, got = budget.collectives.get(prim, 0), actual.get(prim, 0)
        if want != got:
            out.append(Violation(
                "TD101", path, 0,
                f"{prim}: expected {want} per step, the step called {got} — the step's "
                "collective inventory drifted from the parallelism config's budget",
                snippet=f"{prim}:{got}"))
    if counts["transfers"] > budget.transfers:
        out.append(Violation(
            "TD102", path, 0,
            f"{counts['transfers']} host-device transfer op(s) inside the step (a "
            f"_local_scalar_dense or a cross-device copy; budget {budget.transfers}) — "
            "host-device traffic on the hot path",
            snippet=f"transfers:{counts['transfers']}"))
    if budget.bf16_to_f32 is not None and counts["bf16_to_f32"] != budget.bf16_to_f32:
        out.append(Violation(
            "TD103", path, 0,
            f"{counts['bf16_to_f32']} bf16->f32 casts, the mixed-precision policy declares "
            f"{budget.bf16_to_f32} — an op is implicitly promoting to f32",
            snippet=f"bf16_to_f32:{counts['bf16_to_f32']}"))
    return out
