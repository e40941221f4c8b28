"""Device-memory observability: the memory ledger, the pre-flight check
and OOM forensics. The port's counterpart of ``tpu_dist/obs/memory.py``.

* **Static per-leaf ledger** (:func:`static_ledger`): named sections of
  tensors, ``nn.Module``s (their parameters) and dicts or lists of them,
  each leaf's bytes from its shape and dtype, at the extent one device
  holds and in total. Paths are the JAX pytree's ``keystr`` names
  (``bridge.py``'s map; :func:`state_sections` lays a ``TrainState`` out
  as the JAX trainer's sections). A ZeRO-1 flat shard and the
  ``int8_ef`` residuals count their rank's part per device and the whole
  padded vector in total, as JAX counts a ``P('data')`` leaf: ceil(L/n)
  elements a chip.
* **Live census and reconciliation** (:func:`live_census`,
  :func:`reconcile`, :func:`ledger`): the counterpart of
  ``jax.live_arrays()`` is one pass over ``gc.get_objects()`` keeping the
  tensors on the process's device, each storage counted once (keyed by
  its ``data_ptr``: views and aliases count once). It is set against the
  same card's allocator (``torch.cuda.memory_stats``) so that ``attributed
  + unattributed == bytes_in_use`` holds exactly, by construction:
  tensors only C++ holds (autograd's saved tensors, the CUDA graph pool,
  NCCL, the cuDNN and cuBLAS workspaces) and the allocator's rounding land
  in ``unattributed``, as XLA's workspace does in JAX. On the CPU the
  census is the authority (``source: "census"``).
* **Pre-flight** (:func:`feasibility`, :func:`preflight_check`): the static
  requirement against the card's memory (``costmodel.CHIP_HBM_BYTES``)
  times a headroom, before the first step; ``--memory_check
  warn|refuse`` and ``--memory_headroom``, ``--hbm_budget_bytes``.
* **OOM forensics** (:func:`parse_resource_exhausted`): the JAX package's
  ``RESOURCE_EXHAUSTED`` texts as that package reads them, and PyTorch's
  CUDA text (``CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has
  a total capacity of 79.10 GiB of which ...``), whose lowercase "out of
  memory" the JAX markers miss. :func:`write_oom_report` writes the report
  and the ledger snapshot beside the flight ring as ``oom.json``, which
  ``obs postmortem`` turns into the ``oom`` verdict.

The trainer publishes the ledger as ``mem.*`` gauges and one ``memory``
history record; :func:`memory_report` and :func:`format_report_text` are
``python -m tpu_dist_torch.obs memory <run.jsonl>``, and
``memory --oom <text>`` parses a raw out-of-memory text. Exit codes: 0
report, 1 no memory telemetry or no OOM signature, 2 unreadable input.

The parser, reconciliation, feasibility math and formatters are plain
stdlib; torch is imported only by the functions that read tensors.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import time
from typing import Dict, List, Optional

from tpu_dist_torch.obs import counters as counters_lib

#: Per-section leaves listed by size in the ledger (the rest are summed).
TOP_LEAVES = 5

#: Per-rank OOM-report artifact name inside a crash directory (rank 0
#: bare, rank k ``.h<k>``, as the flight ring).
OOM_NAME = "oom.json"


class InfeasibleMemoryError(ValueError):
    """The static ledger does not fit the card's memory and
    ``--memory_check refuse`` asked for a stop before the first step."""


# -- the static per-leaf ledger: shapes and dtypes, no device work ------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A leaf known by its metadata: the global ``shape`` and ``dtype`` (a
    numpy name) and, for a leaf laid over the ranks, the ``shard_shape``
    one device holds (None: every device holds all of it)."""

    shape: tuple
    dtype: str
    shard_shape: Optional[tuple] = None


def _dtype_of(leaf) -> Optional[tuple]:
    """``(name, itemsize)`` of a leaf's dtype, named as numpy (and JAX)
    name it; None for a non-array leaf."""
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return None
    if type(dtype).__module__ == "torch":
        return str(dtype).removeprefix("torch."), dtype.itemsize
    import numpy as np  # noqa: PLC0415

    try:
        dt = np.dtype(dtype)
    except TypeError:
        return None
    return str(dt), dt.itemsize


def _leaf_entry(path: str, leaf) -> Optional[dict]:
    """One leaf's byte accounting from metadata alone: ``bytes_total`` =
    shape x itemsize; ``bytes_per_device`` = the extent one device holds
    (the total for a leaf every device holds). None for a non-array leaf."""
    shape = getattr(leaf, "shape", None)
    named = _dtype_of(leaf)
    if shape is None or named is None:
        return None
    dtype, itemsize = named
    shape = tuple(int(s) for s in shape)
    total = int(math.prod(shape)) * itemsize if shape else itemsize
    per_device = total
    shard = getattr(leaf, "shard_shape", None)
    if shard is not None:
        per_device = int(math.prod(shard)) * itemsize if shard else itemsize
    return {
        "path": path,
        "bytes_per_device": per_device,
        "bytes_total": total,
        "shape": list(shape),
        "dtype": dtype,
        "sharded": per_device < total,
    }


def _module_params(module, fsdp=None) -> dict:
    """A module's parameters as the JAX parameter tree (``bridge.py``'s
    names and layout) for the ResNets and ViTs, else by their dotted
    names. A tensor-, expert- or pipeline-parallel module's sharded leaves
    (a stage's stacked block rows, with their TP shards under PP×TP), and
    under FSDP (``fsdp``, the state's :class:`~tpu_dist_torch.parallel.
    fsdp.FSDPShards`) the leaves it shards over the data axis, are
    :class:`Leaf` s of their full shape and this rank's shard shape, as the
    JAX ledger reads a leaf's sharding (``tpu_dist/obs/memory.py:112-156``)."""
    from tpu_dist_torch import bridge  # noqa: PLC0415

    try:
        full = bridge.jax_layout_template(module)[0]
    except TypeError:
        return dict(module.named_parameters())
    if getattr(module, "shard_axis", None) is None and fsdp is None:
        return full
    local = {k: tuple(v.shape) for k, v in bridge.keystr_leaves(
        bridge.jax_layout_template(module, local=True)[0]).items()}
    if fsdp is not None:
        layout = bridge.leaf_layout(module)
        for name, d in zip(fsdp.names, fsdp.dims):
            if d is not None:
                lay = layout[name]
                shape = list(local[lay.key])
                shape[lay.perm.index(d)] //= fsdp.n
                local[lay.key] = tuple(shape)
    return bridge.keystr_unflatten({
        k: (Leaf(v.shape, str(v.dtype), local[k]) if tuple(v.shape) != local[k] else v)
        for k, v in bridge.keystr_leaves(full).items()})


def _walk(tree, prefix: str, out: list) -> None:
    """``(keystr path, leaf)`` pairs in JAX's flattening order: dict keys
    sorted, sequences by index, a module as its parameter tree."""
    import torch  # noqa: PLC0415

    if isinstance(tree, torch.nn.Module):
        _walk(_module_params(tree), prefix, out)
    elif isinstance(tree, dict):
        for key in sorted(tree):
            _walk(tree[key], f"{prefix}[{key!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, node in enumerate(tree):
            _walk(node, f"{prefix}[{i}]", out)
    elif tree is not None:
        out.append((prefix, tree))


def static_ledger(**sections) -> dict:
    """Per-leaf static accounting of named sections (``params=...,
    opt_state=..., ef=..., bn_state=..., batch=...``): per section the
    per-device and total bytes, leaf count, sharded-leaf count, and the
    :data:`TOP_LEAVES` largest leaves by per-device bytes. Sections that
    are None/empty are recorded with zero bytes."""
    out_sections: Dict[str, dict] = {}
    per_device = total = leaves = 0
    for name, tree in sections.items():
        pairs: list = []
        _walk(tree, "", pairs)
        entries = [e for e in (_leaf_entry(p, leaf) for p, leaf in pairs) if e is not None]
        sec_dev = sum(e["bytes_per_device"] for e in entries)
        sec_tot = sum(e["bytes_total"] for e in entries)
        entries.sort(key=lambda e: -e["bytes_per_device"])
        out_sections[name] = {
            "bytes_per_device": sec_dev,
            "bytes_total": sec_tot,
            "n_leaves": len(entries),
            "sharded_leaves": sum(e["sharded"] for e in entries),
            "top": entries[:TOP_LEAVES],
        }
        per_device += sec_dev
        total += sec_tot
        leaves += len(entries)
    return {
        "sections": out_sections,
        "bytes_per_device": per_device,
        "bytes_total": total,
        "n_leaves": leaves,
    }


def state_sections(state) -> dict:
    """A ``TrainState`` as the JAX trainer's ledger sections ``params``,
    ``opt_state``, ``ef`` and ``bn_state``, in the JAX pytree's names: the
    momentum (SGD, LARS) and AdamW's and LAMB's ``mu``/``nu`` mirror the
    parameter tree; under ZeRO-1 the flat state is one leaf of
    ``layout.padded`` elements, ``layout.chunk`` a device; the ``int8_ef``
    residuals are ``r1`` (``world·padded``, a row a device) and ``r2``
    (``padded``, a chunk a device). A tensor- or expert-parallel model's
    shards, and the optimizer state that mirrors them, are ``sharded``:
    their bytes a device are the shard's; so are FSDP's shards
    (``state.fsdp``) and the optimizer state over them."""
    import torch  # noqa: PLC0415

    from tpu_dist_torch import bridge  # noqa: PLC0415

    model, lay = state.params, state.layout
    try:
        bn_state = bridge.jax_layout_template(model)[1]
    except TypeError:
        bn_state = dict(state.bn_state or {})
    params = _module_params(model, state.fsdp)

    n_params = len(list(model.parameters()))

    def flat(t):
        return Leaf((lay.padded,), _dtype_of(t)[0], (lay.chunk,))

    def mirror(bufs):
        return params if len(bufs) == n_params else list(bufs)

    opt = state.opt_state
    if isinstance(opt, torch.Tensor):
        opt_tree = flat(opt) if lay is not None else opt
    elif isinstance(opt, dict) and {"mu", "nu"} <= set(opt):
        opt_tree = {k: v if k not in ("mu", "nu") else flat(v) if lay is not None else mirror(v)
                    for k, v in opt.items()}
    elif isinstance(opt, (list, tuple)):
        opt_tree = mirror(opt)
    else:
        opt_tree = opt
    ef = {}
    for k, v in (state.ef or {}).items():
        ef[k] = (Leaf((lay.world * lay.padded,), _dtype_of(v)[0], (lay.padded,)) if k == "r1"
                 else flat(v))
    return {"params": params, "opt_state": opt_tree, "ef": ef, "bn_state": bn_state}


# -- the live census and its reconciliation with the allocator ------------------------


def live_census(device) -> dict:
    """The tensors on ``device`` that Python holds, each storage once (by
    its ``data_ptr``): ``{"n_arrays", "bytes_total", "bytes_by_device":
    {index: bytes}, "bytes_device0"}``, ``n_arrays`` the storages counted
    and ``bytes_device0`` this device's attribution, which
    :func:`reconcile` sets against its allocator. One pass over
    ``gc.get_objects()``: no transfer, no sync."""
    import torch  # noqa: PLC0415

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    seen: Dict[int, int] = {}
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which some
        # module-level proxies answer with a deprecation warning
        if not issubclass(type(obj), torch.Tensor):
            continue
        try:
            if obj.device != device:
                continue
            storage = obj.untyped_storage()
            ptr, nbytes = storage.data_ptr(), storage.nbytes()
        except (RuntimeError, NotImplementedError):  # a storage-less tensor
            continue
        if ptr and nbytes:
            seen[ptr] = max(seen.get(ptr, 0), nbytes)
    total = sum(seen.values())
    return {
        "n_arrays": len(seen),
        "bytes_total": total,
        "bytes_by_device": {str(device.index or 0): total},
        "bytes_device0": total,
    }


def reconcile(census: dict, allocator: Optional[dict]) -> dict:
    """The ledger's closing identity: ``attributed + unattributed ==
    bytes_in_use``, exact by construction. ``attributed`` is the census's
    bytes on the device; ``allocator`` must be the same device's counters
    (:func:`costmodel.device_memory_stats`). ``unattributed`` is defined as
    the device's ``bytes_in_use`` minus the attribution. Where the backend
    keeps no allocator stats (``allocator`` None/empty: the CPU), the
    census itself is the authority: ``bytes_in_use := attributed``,
    ``unattributed := 0``, ``source: "census"``."""
    attributed = int(census.get("bytes_device0", 0))
    in_use = (allocator or {}).get("bytes_in_use")
    if isinstance(in_use, (int, float)):
        in_use = int(in_use)
        return {
            "attributed_bytes": attributed,
            "unattributed_bytes": in_use - attributed,
            "bytes_in_use": in_use,
            "source": "allocator",
        }
    return {
        "attributed_bytes": attributed,
        "unattributed_bytes": 0,
        "bytes_in_use": attributed,
        "source": "census",
    }


def ledger(device, static: Optional[dict] = None, xla: Optional[dict] = None) -> dict:
    """One ledger snapshot of ``device``: the construction-time static
    accounting (``static``), the first step's memory waterfall (``xla``,
    the JAX record's keys, measured by the allocator), the live census, the
    allocator's counters and the reconciliation. This is the ``memory``
    history record and the snapshot ``oom.json`` embeds."""
    from tpu_dist_torch.obs import costmodel  # noqa: PLC0415

    census = live_census(device)
    allocator = costmodel.device_memory_stats(device)
    rec: dict = {
        "census": census,
        "reconciliation": reconcile(census, allocator),
    }
    if static is not None:
        rec["static"] = static
    if xla is not None:
        rec["xla"] = xla
    if allocator is not None:
        rec["allocator"] = allocator
    return rec


def publish_ledger(rec: dict) -> None:
    """Stamp a ledger snapshot into the ``mem.*`` gauges: every later
    history record and OpenMetrics exposition carries the numbers."""
    static = rec.get("static") or {}
    if static.get("bytes_per_device"):
        counters_lib.set_gauge(
            "mem.static_bytes_per_device", static["bytes_per_device"]
        )
    xla = rec.get("xla") or {}
    for key, gauge in (
        ("argument_bytes", "mem.xla_argument_bytes"),
        ("output_bytes", "mem.xla_output_bytes"),
        ("temp_bytes", "mem.xla_temp_bytes"),
        ("generated_code_bytes", "mem.xla_code_bytes"),
        ("peak_bytes", "mem.xla_peak_bytes"),
    ):
        v = xla.get(key)
        if isinstance(v, (int, float)):
            counters_lib.set_gauge(gauge, int(v))
    rc = rec.get("reconciliation") or {}
    for key, gauge in (
        ("attributed_bytes", "mem.attributed_bytes"),
        ("unattributed_bytes", "mem.unattributed_bytes"),
    ):
        v = rc.get(key)
        if isinstance(v, (int, float)):
            counters_lib.set_gauge(gauge, int(v))


def record_peak_hbm(rec: dict) -> Optional[int]:
    """A ledger snapshot's gating scalar (a ``memory`` history record, of
    either package): the allocator's peak where the record has one, else
    XLA's static ``peak_bytes`` estimate, else the reconciled
    ``bytes_in_use``. None on an empty record."""
    alloc = rec.get("allocator") or {}
    v = alloc.get("peak_bytes_in_use")
    if isinstance(v, (int, float)) and v > 0:
        return int(v)
    xla = rec.get("xla") or {}
    v = xla.get("peak_bytes")
    if isinstance(v, (int, float)) and v > 0:
        return int(v)
    v = (rec.get("reconciliation") or {}).get("bytes_in_use")
    return int(v) if isinstance(v, (int, float)) and v > 0 else None


# -- pre-flight feasibility ------------------------------------------------------------


def feasibility(
    required_bytes: int, budget_bytes: int, headroom: float = 0.9,
) -> dict:
    """Does a per-device static requirement fit a per-card budget?
    ``headroom`` is the fraction of the budget the static estimate may
    claim; the rest is left for the step's temporaries, workspaces and
    fragmentation, which the static ledger cannot see (``unattributed``
    measures them after the fact). ``utilization`` is required/budget."""
    if budget_bytes <= 0:
        raise ValueError(f"budget_bytes must be positive, got {budget_bytes}")
    if not 0.0 < headroom <= 1.0:
        raise ValueError(f"headroom must be in (0, 1], got {headroom}")
    allowed = int(budget_bytes * headroom)
    return {
        "required_bytes": int(required_bytes),
        "budget_bytes": int(budget_bytes),
        "headroom": headroom,
        "allowed_bytes": allowed,
        "utilization": round(required_bytes / budget_bytes, 4),
        "fits": required_bytes <= allowed,
    }


def preflight_check(
    required_bytes: int,
    *,
    budget_bytes: Optional[int] = None,
    headroom: float = 0.9,
    action: str = "warn",
    chip_kind: Optional[str] = None,
) -> Optional[dict]:
    """The trainer's pre-flight memory check. ``budget_bytes`` overrides
    the chip-table lookup (``costmodel.chip_hbm_bytes``); an unknown card
    with no override (the CPU) returns None: no budget, no check, never a
    guess. ``action``: ``"off"`` skips, ``"warn"`` returns the report (the
    caller prints), ``"refuse"`` raises :class:`InfeasibleMemoryError` on
    a miss, before the first step can run out of memory. The message is
    the JAX package's."""
    if action not in ("off", "warn", "refuse"):
        raise ValueError(
            f"memory_check must be off|warn|refuse, got {action!r}"
        )
    if action == "off":
        return None
    if budget_bytes is None:
        from tpu_dist_torch.obs import costmodel  # noqa: PLC0415

        budget_bytes = costmodel.chip_hbm_bytes(chip_kind)
    if budget_bytes is None:
        return None
    report = feasibility(required_bytes, budget_bytes, headroom)
    if not report["fits"] and action == "refuse":
        raise InfeasibleMemoryError(
            f"static HBM requirement {fmt_bytes(report['required_bytes'])} "
            f"per device exceeds {headroom:.0%} of the "
            f"{fmt_bytes(report['budget_bytes'])} per-chip budget "
            f"(allowed {fmt_bytes(report['allowed_bytes'])}) — the config "
            "cannot fit before XLA temps are even counted; shard more "
            "(--shard_weight_update/--fsdp), shrink the batch, or raise "
            "--memory_headroom / pass --memory_check warn to proceed anyway"
        )
    return report


# -- OOM forensics: an out-of-memory text -> a typed report ------------------

_SIZE_RE = r"(\d+(?:\.\d+)?)\s*([KMGTP]i?B?|B|bytes?)"
_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED", "Out of memory", "Ran out of memory",
    "OOM when allocating",
    "CUDA out of memory",  # PyTorch's torch.OutOfMemoryError
)
#: Multiplier per size-prefix letter; the ``iB``/``B`` tail and letter
#: case are normalized away in :func:`_to_bytes` (the size regexes run
#: IGNORECASE, so a lowercase ``2.5g`` must not silently parse as 2 B).
_UNIT_PREFIX = {
    "K": 1024, "M": 1024 ** 2, "G": 1024 ** 3,
    "T": 1024 ** 4, "P": 1024 ** 5,
}

_ALLOCATE_RE = re.compile(
    r"allocat\w+\s+(?:of\s+)?" + _SIZE_RE, re.IGNORECASE
)
_USED_OF_RE = re.compile(
    r"Used\s+" + _SIZE_RE + r"\s+of\s+" + _SIZE_RE, re.IGNORECASE
)
_EXCEEDED_RE = re.compile(
    r"Exceeded\s+\w+\s+capacity\s+by\s+" + _SIZE_RE, re.IGNORECASE
)
# PyTorch's accounting: "GPU 0 has a total capacity of 79.10 GiB of which
# 1.05 GiB is free. ... Of the allocated memory 76.50 GiB is allocated by
# PyTorch, and ..."
_TORCH_LIMIT_RE = re.compile(r"total capacity of\s+" + _SIZE_RE, re.IGNORECASE)
_TORCH_USED_RE = re.compile(
    r"allocated memory\s+" + _SIZE_RE + r"\s+is allocated by PyTorch", re.IGNORECASE
)
_BUFFER_RE = re.compile(r"^\s*(\d+)\.\s+Size:\s*" + _SIZE_RE)
_SHAPE_RE = re.compile(r"^\s*Shape:\s*(\S.*)$")
_OP_RE = re.compile(r'^\s*Operator:\s*op_name="([^"]*)"')
_XLA_LABEL_RE = re.compile(r"^\s*XLA Label:\s*(\S.*)$")


def _to_bytes(num: str, unit: str) -> int:
    u = unit.strip()
    if u.lower() in ("b", "byte", "bytes"):
        return int(float(num))
    return int(float(num) * _UNIT_PREFIX.get(u[0].upper(), 1))


def parse_resource_exhausted(text: str) -> Optional[dict]:
    """Structure an XLA ``RESOURCE_EXHAUSTED`` or a PyTorch CUDA OOM message. Returns None when
    the text carries no OOM marker at all (garbage / a different error);
    otherwise a typed report with whatever the (possibly TRUNCATED —
    flight-ring slots cap messages at 200 chars) text still holds:

    * ``headline`` — the first marker line, trimmed,
    * ``requested_bytes`` — the failed allocation ("while trying to
      allocate 2.50G"),
    * ``used_bytes`` / ``limit_bytes`` / ``excess_bytes`` — XLA's
      "Used X of Y hbm … Exceeded hbm capacity by Z" accounting, or
      PyTorch's "total capacity of Y … X is allocated by PyTorch",
    * ``buffers`` — the "Largest program allocations" table, each entry
      ``{rank, size_bytes, shape?, op?}`` (up to 16),
    * ``buffers_bytes`` — their sum.

    Absent fields were simply not in the text; a report with only a
    headline is still a report (the truncated-ring case)."""
    if not text or not any(m in text for m in _OOM_MARKERS):
        return None
    report: dict = {"kind": "oom"}
    for line in text.splitlines():
        if any(m in line for m in _OOM_MARKERS):
            report["headline"] = line.strip()[:240]
            break
    m = _ALLOCATE_RE.search(text)
    if m:
        report["requested_bytes"] = _to_bytes(m.group(1), m.group(2))
    m = _USED_OF_RE.search(text)
    if m:
        report["used_bytes"] = _to_bytes(m.group(1), m.group(2))
        report["limit_bytes"] = _to_bytes(m.group(3), m.group(4))
    else:
        lim, used = _TORCH_LIMIT_RE.search(text), _TORCH_USED_RE.search(text)
        if lim and used:
            report["used_bytes"] = _to_bytes(used.group(1), used.group(2))
            report["limit_bytes"] = _to_bytes(lim.group(1), lim.group(2))
    m = _EXCEEDED_RE.search(text)
    if m:
        report["excess_bytes"] = _to_bytes(m.group(1), m.group(2))
    buffers: List[dict] = []
    cur: Optional[dict] = None
    for line in text.splitlines():
        bm = _BUFFER_RE.match(line)
        if bm:
            if len(buffers) >= 16:
                break
            cur = {
                "rank": int(bm.group(1)),
                "size_bytes": _to_bytes(bm.group(2), bm.group(3)),
            }
            buffers.append(cur)
            continue
        if cur is None:
            continue
        sm = _SHAPE_RE.match(line)
        if sm:
            cur["shape"] = sm.group(1).strip()[:120]
            continue
        om = _OP_RE.match(line) or _XLA_LABEL_RE.match(line)
        if om and "op" not in cur:
            cur["op"] = om.group(1).strip()[:160]
    if buffers:
        report["buffers"] = buffers
        report["buffers_bytes"] = sum(b["size_bytes"] for b in buffers)
    return report


def oom_summary_line(report: dict) -> str:
    """One human line for the rank-0 warning / tail event / postmortem:
    ``'OOM: requested 2.5GiB, used 15.9GiB of 16.0GiB (3 largest buffers
    account for 12.1GiB)'``."""
    parts = []
    if report.get("requested_bytes"):
        parts.append(f"requested {fmt_bytes(report['requested_bytes'])}")
    if report.get("used_bytes") and report.get("limit_bytes"):
        parts.append(
            f"used {fmt_bytes(report['used_bytes'])} of "
            f"{fmt_bytes(report['limit_bytes'])}"
        )
    elif report.get("excess_bytes"):
        parts.append(f"over capacity by {fmt_bytes(report['excess_bytes'])}")
    if report.get("buffers"):
        parts.append(
            f"{len(report['buffers'])} largest buffers account for "
            f"{fmt_bytes(report.get('buffers_bytes', 0))}"
        )
    return "OOM: " + (", ".join(parts) if parts else
                      report.get("headline", "RESOURCE_EXHAUSTED"))


def write_oom_report(
    path: str, report: dict, snapshot: Optional[dict] = None,
) -> Optional[str]:
    """The crash artifact: the parsed allocation report plus the ledger
    snapshot that was live at the time, as one JSON next to the flight
    ring. Never raises — a full disk must not mask the OOM that is
    already propagating."""
    rec = {"ts": round(time.time(), 3), "oom": report}
    if snapshot:
        rec["ledger"] = snapshot
    try:
        # the caller derives one oom.json path per rank (per_rank_path),
        # exactly the flight-ring discipline
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
    except OSError:
        counters_lib.inc("mem.oom_report_errors")
        return None
    return path


def read_oom_report(path: str) -> Optional[dict]:
    """Postmortem-side read of :func:`write_oom_report`'s artifact; None
    on a missing/torn file (the expected input after a crash)."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


# -- formatting ------------------------------------------------------------------


def fmt_bytes(n) -> str:
    """Human bytes: ``'1.5GiB'`` / ``'320.0MiB'`` / ``'512B'`` / ``'-'``."""
    if not isinstance(n, (int, float)):
        return "-"
    neg = n < 0
    v = float(abs(n))
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if v < 1024 or unit == "TiB":
            body = f"{v:.0f}B" if unit == "B" else f"{v:.1f}{unit}"
            return ("-" if neg else "") + body
        v /= 1024
    return str(n)


def summary_line(rec: dict) -> str:
    """One line per ledger snapshot: the trainer's first-dispatch line,
    its OOM line and the postmortem text."""
    static = rec.get("static") or {}
    xla = rec.get("xla") or {}
    rc = rec.get("reconciliation") or {}
    parts = []
    if static.get("bytes_per_device"):
        parts.append(f"static {fmt_bytes(static['bytes_per_device'])}/device")
    if isinstance(xla.get("peak_bytes"), (int, float)):
        parts.append(f"xla peak {fmt_bytes(xla['peak_bytes'])}")
    if rc:
        parts.append(
            f"in use {fmt_bytes(rc.get('bytes_in_use'))} "
            f"(attributed {fmt_bytes(rc.get('attributed_bytes'))} + "
            f"unattributed {fmt_bytes(rc.get('unattributed_bytes'))}, "
            f"{rc.get('source')})"
        )
    return "memory ledger: " + (", ".join(parts) or "(empty)")


def format_ledger_text(rec: dict) -> str:
    """The full ledger rendering (``obs memory``): per-section table,
    the XLA waterfall, the reconciliation identity, allocator skew."""
    lines = [summary_line(rec)]
    static = rec.get("static") or {}
    sections = static.get("sections") or {}
    if sections:
        lines.append(
            f"  {'section':>10} {'per-device':>12} {'total':>12} "
            f"{'leaves':>7} {'sharded':>8}"
        )
        for name in sorted(
            sections, key=lambda n: -sections[n]["bytes_per_device"]
        ):
            s = sections[name]
            lines.append(
                f"  {name:>10} {fmt_bytes(s['bytes_per_device']):>12} "
                f"{fmt_bytes(s['bytes_total']):>12} {s['n_leaves']:>7} "
                f"{s['sharded_leaves']:>8}"
            )
            for e in s.get("top") or []:
                lines.append(
                    f"      {fmt_bytes(e['bytes_per_device']):>10}  "
                    f"{e['path']} {e['dtype']}{e['shape']}"
                    + (" [sharded]" if e.get("sharded") else "")
                )
    xla = rec.get("xla") or {}
    if xla:
        lines.append(
            "  xla waterfall: args "
            f"{fmt_bytes(xla.get('argument_bytes'))}, outputs "
            f"{fmt_bytes(xla.get('output_bytes'))}, temps "
            f"{fmt_bytes(xla.get('temp_bytes'))}, codegen "
            f"{fmt_bytes(xla.get('generated_code_bytes'))} -> peak "
            f"{fmt_bytes(xla.get('peak_bytes'))}"
        )
    alloc = rec.get("allocator") or {}
    if alloc:
        skew = alloc.get("bytes_in_use_skew")
        lines.append(
            "  allocator: in use "
            f"{fmt_bytes(alloc.get('bytes_in_use'))} (worst chip)"
            + (
                f", min {fmt_bytes(alloc.get('bytes_in_use_min'))}, "
                f"skew {fmt_bytes(skew)}"
                if skew is not None else ""
            )
            + (
                f", peak {fmt_bytes(alloc.get('peak_bytes_in_use'))}"
                if alloc.get("peak_bytes_in_use") is not None else ""
            )
            + (
                f", limit {fmt_bytes(alloc.get('bytes_limit'))}"
                if alloc.get("bytes_limit") is not None else ""
            )
        )
    return "\n".join(lines)


def format_oom_text(report: dict) -> str:
    lines = [oom_summary_line(report)]
    if report.get("headline"):
        lines.append(f"  {report['headline']}")
    for b in report.get("buffers") or []:
        lines.append(
            f"  {b['rank']:>3}. {fmt_bytes(b['size_bytes']):>10}"
            + (f"  {b['shape']}" if b.get("shape") else "")
            + (f"  {b['op']}" if b.get("op") else "")
        )
    return "\n".join(lines)


# -- the history report (`obs memory <run.jsonl>`) ------------------------------------


def memory_report(records: List[dict]) -> dict:
    """Fold a run's history into the memory view: the ``memory`` ledger
    records, the per-epoch ``mem.*`` gauge series out of the counter
    snapshots, any OOM events, and the single ``peak_hbm_bytes`` scalar
    ``obs compare`` gates on."""
    ledgers: List[dict] = []
    ooms: List[dict] = []
    series: List[dict] = []
    peak: Optional[int] = None
    for rec in records:
        kind = rec.get("kind")
        if kind == "memory":
            if rec.get("event") == "oom":
                ooms.append({
                    k: rec.get(k) for k in ("epoch", "oom", "ledger")
                    if rec.get(k) is not None
                })
            else:
                ledgers.append(rec)
                p = record_peak_hbm(rec)
                if p is not None:
                    peak = max(peak or 0, p)
        cnt = rec.get("counters")
        if kind == "train_epoch" and isinstance(cnt, dict):
            row = {
                k.split("mem.", 1)[1]: v for k, v in cnt.items()
                if k.startswith("mem.") and isinstance(v, (int, float))
            }
            if row:
                row["epoch"] = rec.get("epoch")
                series.append(row)
        if isinstance(cnt, dict):
            v = cnt.get("mem.peak_bytes_in_use")
            if isinstance(v, (int, float)) and v > 0:
                peak = max(peak or 0, int(v))
    return {
        "ledgers": ledgers,
        "ooms": ooms,
        "epoch_series": series,
        "peak_hbm_bytes": peak,
    }


def format_report_text(report: dict) -> str:
    lines: List[str] = []
    for led in report["ledgers"]:
        lines.append(format_ledger_text(led))
    if report["epoch_series"]:
        lines.append("per-epoch mem.* gauges (worst chip):")
        lines.append(
            f"  {'epoch':>5} {'in_use':>10} {'peak':>10} {'headroom':>9} "
            f"{'skew':>10}"
        )
        for row in report["epoch_series"]:
            hr = row.get("headroom_frac")
            ep = row.get("epoch")
            lines.append(
                f"  {(ep if ep is not None else '-'):>5} "
                f"{fmt_bytes(row.get('bytes_in_use')):>10} "
                f"{fmt_bytes(row.get('peak_bytes_in_use')):>10} "
                f"{(format(hr, '.1%') if isinstance(hr, (int, float)) else '-'):>9} "
                f"{fmt_bytes(row.get('bytes_in_use_skew')):>10}"
            )
    for o in report["ooms"]:
        lines.append("OOM event" + (
            f" at epoch {o['epoch']}" if o.get("epoch") is not None else ""
        ) + ":")
        if isinstance(o.get("oom"), dict):
            lines.append("  " + oom_summary_line(o["oom"]))
    if report["peak_hbm_bytes"] is not None:
        lines.append(
            f"peak HBM (compare gate scalar): "
            f"{fmt_bytes(report['peak_hbm_bytes'])} "
            f"({report['peak_hbm_bytes']} B)"
        )
    if not lines:
        lines.append("no memory telemetry in this history")
    return "\n".join(lines)
