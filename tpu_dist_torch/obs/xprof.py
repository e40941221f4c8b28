"""Profile analytics: read ``torch.profiler`` captures back. The port's
counterpart of ``tpu_dist/obs/xprof.py``, with the same report, the same
categories, typed errors, interval math and failure posture; what differs
is the trace it reads and how it picks the device's work out of it.

The triggered profiler (``obs/profile.py``) writes each rank's capture as
a Chrome trace (``<capture_dir>/rank<k>.trace.json.gz``, gzip + JSON, as
Kineto exports it). This module turns a capture into an attribution
report:

* **Per-category device seconds**: every op event on a device track is
  classified (``matmul_conv`` / ``collective`` / ``infeed_outfeed`` /
  ``fusion_other`` / ``host``) and charged its SELF time, so the category
  seconds sum to the device's busy time by construction, the invariant
  the tests pin. On a CPU thread that is the duration minus nested
  children, as in the JAX reader; on a device stream, where kernels do
  not nest but may overlap (programmatic dependent launch), the time not
  covered by the stream's earlier kernels, so that busy is each stream's
  interval union.
* **Comm/compute overlap**: the fraction of collective wall time during
  which compute also ran (interval union and intersection across the
  device's streams: an NCCL kernel on its own stream beside a gemm).
* **Collectives by kind**, **top-k ops by self time**, and
  **infeed-stall seconds** (host-to-device copies the device waited on).

Track selection. Kineto puts the card's work on the GPU's process (pid =
device index) with one thread a CUDA stream. Only the device's own
activity counts as ops there: events whose ``cat`` is ``kernel``,
``gpu_memcpy`` or ``gpu_memset``. The same tracks carry
``gpu_user_annotation`` ranges, which mirror ``record_function`` spans on
the device's clock: alternate views of the same time, which would make
every annotated range eat its kernels' self time; they are never
selected. A trace with no such event (a CPU run) is read by content
instead, the counterpart of the JAX reader's ``args.hlo_op`` path:
``cpu_op`` events of the ATen and ``c10d::`` operators count
(:data:`CPU_OP_PREFIXES`), runtime bookkeeping (the autograd engine's
wrapper ranges, ``cuda_runtime``, ``python_function``, annotations, the
profiler's own ``Trace`` span) does not. A capture with neither is a typed
:class:`NoDeviceTrackError`.

Classification (:func:`classify`, pinned by the tests):

* ``nccl*Kernel*`` kernels are ``collective``, their kind read from
  ``AllReduce``/``AllGather``/``ReduceScatter``/``Broadcast``/``SendRecv``
  (:data:`NCCL_KINDS`, onto :data:`COLLECTIVE_KINDS`); on a CPU trace the
  ``c10d::`` operators are, by their names;
* cuBLAS, CUTLASS, ``xmma``, ``gemm``/``gemv`` and cuDNN convolution
  kernels (``fprop``/``dgrad``/``wgrad``/``implicit``/``winograd``), and
  the port's own tensor-core flash kernels (``flash_fwd*``, ``dkdv*``,
  ``dq*``) are ``matmul_conv``, as are the ATen matmul and convolution
  operators on a CPU trace;
* host-to-device and device-to-host copies are ``infeed_outfeed``, the
  host-to-device ones also ``infeed_stall_s``;
* every other kernel (``fused_sgd_kernel`` included), memset and
  device-to-device copy is ``fusion_other``. ``host`` stays for the
  report's shape: no selected event is runtime bookkeeping.

Failure posture: the analyzer runs inside the training process (the
profiler reads every capture back when it closes), so malformed input
never crashes it. A truncated gzip, a torn JSON tail or a track-less trace
file is a counted drop in a partial report, and only a capture with
nothing analyzable raises (a :class:`CaptureError` subclass the hook
catches). Stdlib only.
"""

from __future__ import annotations

import gzip
import json
import os
import re
from typing import Dict, List, Optional, Tuple

#: Attribution categories; their seconds sum to ``device_busy_s``.
CATEGORIES = (
    "matmul_conv", "collective", "infeed_outfeed", "fusion_other", "host",
)

#: The JAX reader's collective kinds; the port's kinds are named by these.
COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "all-to-all",
    "ragged-all-to-all",
    "reduce-scatter",
    "collective-permute",
    "collective-broadcast",
    "send",
    "recv",
)

#: An NCCL kernel's operation (in its name) -> its collective kind.
#: NCCL runs all-to-all and point-to-point exchanges as ``SendRecv``.
NCCL_KINDS = (
    ("AllReduce", "all-reduce"),
    ("AllGather", "all-gather"),
    ("ReduceScatter", "reduce-scatter"),
    ("Broadcast", "collective-broadcast"),
    ("SendRecv", "send"),
    ("Send", "send"),
    ("Recv", "recv"),
)

#: A ``c10d::`` operator (a CPU trace's collectives) -> its kind.
C10D_KINDS = (
    ("allreduce", "all-reduce"),
    ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("alltoall", "all-to-all"),
    ("broadcast", "collective-broadcast"),
    ("send", "send"),
    ("recv", "recv"),
)

#: The ``cat`` of Kineto's device activity: the only events of a GPU track
#: that count (``gpu_user_annotation`` ranges mirror host spans).
DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
#: The operators a CPU trace's ``cpu_op`` events count by: ATen's and the
#: collectives'. The rest of that category is the autograd engine's
#: wrappers (``autograd::engine::evaluate_function: ...``, ``*Backward0``)
#: and custom autograd functions, whose ranges hold operators and would
#: eat their self time.
CPU_OP_PREFIXES = ("aten::", "c10d::")

#: Substrings (lowercase) of a kernel's name that make it matmul/conv:
#: cuBLAS, CUTLASS and cuDNN's convolution kernels. No bare ``conv``
#: (``convert`` kernels stay in ``fusion_other``) and no bare ``cudnn``
#: (its batch-norm kernels are no convolution).
_MATMUL_TOKENS = (
    "gemm", "gemv", "xmma", "cutlass", "cublas", "fprop", "dgrad", "wgrad",
    "implicit", "winograd", "conv2d", "convolution", "convolve", "matmul",
)
#: The port's own tensor-core kernels (``csrc/flash_attention_*.cu``),
#: by the start of the kernel function's name.
_FLASH_PREFIXES = ("flash_fwd", "dkdv", "dq_")
#: ATen operators (a CPU trace) that are matmul/conv.
_ATEN_MATMUL = re.compile(
    r"^aten::(mm|addmm|bmm|baddbmm|matmul|linear|einsum|_?convolution(_backward)?|"
    r"conv\d?d|mkldnn_convolution|cudnn_convolution|_scaled_dot_product\w*|"
    r"_flash_attention\w*|_efficient_attention\w*)$"
)


# --------------------------------------------------------------------------
# Typed errors: the auto-analyze hook's catch surface.
# --------------------------------------------------------------------------


class CaptureError(Exception):
    """Base: this capture yielded no analyzable device timeline."""

    kind = "capture_error"


class EmptyCaptureError(CaptureError):
    """No ``*.trace.json.gz`` under the capture directory at all."""

    kind = "empty_capture"


class MalformedTraceError(CaptureError):
    """Trace file unreadable: truncated gzip, torn/invalid JSON."""

    kind = "malformed_trace"


class NoDeviceTrackError(CaptureError):
    """The trace parsed but carries no device activity to attribute."""

    kind = "no_device_track"


# --------------------------------------------------------------------------
# Classification
# --------------------------------------------------------------------------


def kernel_base(name: str) -> str:
    """A kernel's function name without its return type, namespace-free
    template arguments or parameters: ``void flash_fwd_mma_kernel<64,
    __nv_bfloat16>(...)`` -> ``flash_fwd_mma_kernel``."""
    s = name.strip()
    if s.startswith("void "):
        s = s[5:]
    for stop in ("(", "<"):
        i = s.find(stop)
        if i > 0:
            s = s[:i]
    return s.rsplit("::", 1)[-1].strip()


def is_collective(name: str) -> bool:
    """An NCCL kernel (``nccl*Kernel*``) or, on a CPU trace, a ``c10d::``
    operator."""
    low = name.lower()
    return name.startswith("c10d::") or ("nccl" in low and "kernel" in low)


def collective_kind(name: str) -> Optional[str]:
    """The collective kind of an event's name (:data:`NCCL_KINDS`,
    :data:`C10D_KINDS`), or None (also for a collective of no known
    kind, which the report files under ``other``)."""
    if not is_collective(name):
        return None
    if name.startswith("c10d::"):
        op = name[len("c10d::"):].lower()
        return next((kind for token, kind in C10D_KINDS if token in op), None)
    return next((kind for token, kind in NCCL_KINDS if token in name), None)


def memcpy_direction(name: str) -> Optional[str]:
    """``HtoD``, ``DtoH``, ``DtoD``... of a Kineto memcpy's name
    (``Memcpy HtoD (Pageable -> Device)``), or None."""
    m = re.search(r"\b([HDP])to([HDP])\b", name)
    return m.group(0) if m else None


def classify(name: str, cat: str = "kernel") -> str:
    """Category of one selected event (see :data:`CATEGORIES`), from its
    name and its Kineto ``cat``."""
    if is_collective(name):
        return "collective"
    if cat == "gpu_memcpy":
        return "infeed_outfeed" if memcpy_direction(name) in ("HtoD", "DtoH") else "fusion_other"
    if cat == "gpu_memset":
        return "fusion_other"
    if cat == "cpu_op":
        return "matmul_conv" if _ATEN_MATMUL.match(name) else "fusion_other"
    low = name.lower()
    if any(t in low for t in _MATMUL_TOKENS):
        return "matmul_conv"
    if kernel_base(name).startswith(_FLASH_PREFIXES):
        return "matmul_conv"
    return "fusion_other"


def _is_infeed(name: str, cat: str) -> bool:
    return cat == "gpu_memcpy" and memcpy_direction(name) == "HtoD"


# --------------------------------------------------------------------------
# Interval math (the JAX reader's, unchanged)
# --------------------------------------------------------------------------


def _self_times_us(events: List[Tuple[float, float, int]]) -> Dict[int, float]:
    """Self time (duration minus nested children, µs) per event index for
    ONE thread's complete events ``(ts, dur, idx)``. Children are clipped
    to their parent, so the per-thread self times sum to the union length
    of the thread's top-level intervals: the invariant that makes the
    category seconds sum to total busy time."""
    out: Dict[int, float] = {}
    stack: List[Tuple[float, int]] = []  # (end_us, idx) of open ancestors
    for ts, dur, idx in sorted(events, key=lambda e: (e[0], -e[1])):
        end = ts + dur
        while stack and stack[-1][0] <= ts:
            stack.pop()
        if stack:
            p_end, p_idx = stack[-1]
            end = min(end, p_end)  # clip clock-jitter overhang to parent
            covered = end - ts
            if covered > 0:
                out[p_idx] = out.get(p_idx, 0.0) - covered
        dur = max(end - ts, 0.0)
        out[idx] = out.get(idx, 0.0) + dur
        stack.append((end, idx))
    return out


def _exclusive_times_us(events: List[Tuple[float, float, int]]) -> Dict[int, float]:
    """Self time (µs) per event index for ONE device stream's events
    ``(ts, dur, idx)``: each kernel's time not already covered by those
    that started before it on the stream. Kernels on a stream do not nest,
    but on Hopper one may start before the previous one ends (cuDNN's
    convolution kernels do, by programmatic dependent launch), where
    :func:`_self_times_us` would take the later kernel for a child and drop
    its time past the earlier one's end. These self times sum to the
    union length of the stream's intervals."""
    out: Dict[int, float] = {}
    end = float("-inf")
    for ts, dur, idx in sorted(events, key=lambda e: (e[0], -e[1])):
        out[idx] = max(ts + dur - max(ts, end), 0.0)
        end = max(end, ts + dur)
    return out


def _merge_intervals(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not ivs:
        return []
    ivs = sorted(ivs)
    out = [list(ivs[0])]
    for a, b in ivs[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _union_len(ivs: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in _merge_intervals(ivs))


def _intersect_len(
    a: List[Tuple[float, float]], b: List[Tuple[float, float]]
) -> float:
    a, b = _merge_intervals(a), _merge_intervals(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


# --------------------------------------------------------------------------
# Trace loading
# --------------------------------------------------------------------------


def find_traces(capture_dir: str) -> List[str]:
    """Every ``*.trace.json.gz`` under ``capture_dir`` (each rank writes
    ``rank<k>.trace.json.gz``; a multi-host tree nests one directory a
    host, and the walk finds them all). Sorted for deterministic
    reports."""
    out: List[str] = []
    for root, _dirs, files in os.walk(capture_dir):
        for f in files:
            if f.endswith(".trace.json.gz"):
                out.append(os.path.join(root, f))
    return sorted(out)


def load_trace(path: str) -> List[dict]:
    """The ``traceEvents`` list of one trace file (``.json`` or
    ``.json.gz``). Raises :class:`MalformedTraceError` on a truncated gzip
    or torn/invalid JSON: typed, so the auto-analyze hook can count the
    drop instead of dying."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8", errors="replace") as f:
                data = json.load(f)
        else:
            with open(path, encoding="utf-8", errors="replace") as f:
                data = json.load(f)
    except (OSError, EOFError, gzip.BadGzipFile) as e:
        raise MalformedTraceError(
            f"{path}: unreadable trace (truncated gzip?): {e}"
        ) from e
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise MalformedTraceError(
            f"{path}: torn/invalid trace JSON: {e}"
        ) from e
    if isinstance(data, list):  # bare event-array form of the spec
        return [e for e in data if isinstance(e, dict)]
    if isinstance(data, dict) and isinstance(data.get("traceEvents"), list):
        return [e for e in data["traceEvents"] if isinstance(e, dict)]
    raise MalformedTraceError(f"{path}: no traceEvents array")


# --------------------------------------------------------------------------
# Per-trace analysis
# --------------------------------------------------------------------------


def _selector(events: List[dict]):
    """``(predicate, device)``: the attribution universe is the device's
    activity when the trace has any (``device`` true), else the CPU's ATen
    and collective operators."""
    if any(e.get("ph") == "X" and e.get("cat") in DEVICE_CATS for e in events):
        return (lambda e: e.get("cat") in DEVICE_CATS), True
    return (lambda e: (e.get("cat") == "cpu_op"
                       and str(e.get("name", "")).startswith(CPU_OP_PREFIXES))), False


def analyze_events(events: List[dict]) -> dict:
    """Attribution over one trace's event list. Raises
    :class:`NoDeviceTrackError` when no device activity and no CPU
    operator exists."""
    selected, device = _selector(events)
    # a device stream's kernels never nest; a CPU thread's operators do
    self_times = _exclusive_times_us if device else _self_times_us
    per_thread: Dict[Tuple[object, object], List[Tuple[float, float, int]]] = {}
    names: List[str] = []
    cats: List[str] = []
    infeed: List[bool] = []
    for e in events:
        if e.get("ph") != "X" or not selected(e):
            continue
        ts, dur = e.get("ts"), e.get("dur")
        if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
            continue
        name, cat = str(e.get("name", "")), str(e.get("cat"))
        idx = len(names)
        names.append(name)
        cats.append(classify(name, cat))
        infeed.append(_is_infeed(name, cat))
        per_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
            (float(ts), float(dur), idx))
    if not per_thread:
        raise NoDeviceTrackError(
            "no device track: the trace has no GPU activity (kernel, gpu_memcpy, "
            "gpu_memset events) and no cpu_op events to attribute"
        )
    cat_us = {c: 0.0 for c in CATEGORIES}
    coll_us: Dict[str, float] = {}
    infeed_us = 0.0
    op_self_us: Dict[str, float] = {}
    op_count: Dict[str, int] = {}
    comm_ivs: List[Tuple[float, float]] = []
    compute_ivs: List[Tuple[float, float]] = []
    busy_us = 0.0
    for evs in per_thread.values():
        selfs = self_times(evs)
        for ts, dur, idx in evs:
            s = selfs.get(idx, 0.0)
            cat = cats[idx]
            cat_us[cat] += s
            busy_us += s
            if cat == "collective":
                kind = collective_kind(names[idx]) or "other"
                coll_us[kind] = coll_us.get(kind, 0.0) + s
                comm_ivs.append((ts, ts + dur))
            elif cat in ("matmul_conv", "fusion_other"):
                compute_ivs.append((ts, ts + dur))
            if infeed[idx]:
                infeed_us += s
            if cat != "host":
                op_self_us[names[idx]] = op_self_us.get(names[idx], 0.0) + s
                op_count[names[idx]] = op_count.get(names[idx], 0) + 1
    comm_us = _union_len(comm_ivs)
    overlapped_us = _intersect_len(comm_ivs, compute_ivs)
    sec = 1e-6
    return {
        "op_threads": len(per_thread),
        "n_op_events": len(names),
        "device_busy_s": busy_us * sec,
        "categories": {c: cat_us[c] * sec for c in CATEGORIES},
        "collectives": {
            k: v * sec for k, v in sorted(coll_us.items())
        },
        "infeed_stall_s": infeed_us * sec,
        "overlap": {
            "comm_s": comm_us * sec,
            "compute_s": _union_len(compute_ivs) * sec,
            "overlapped_s": overlapped_us * sec,
            "overlap_frac": (
                round(overlapped_us / comm_us, 4) if comm_us > 0 else None
            ),
        },
        "_op_self_s": {n: v * sec for n, v in op_self_us.items()},
        "_op_count": op_count,
        "_op_cat": {names[i]: cats[i] for i in range(len(names))},
    }


# --------------------------------------------------------------------------
# Capture-level analysis (the public entry points)
# --------------------------------------------------------------------------


def _top_ops(
    self_s: Dict[str, float], count: Dict[str, int], cat: Dict[str, str], k: int
) -> List[dict]:
    return [
        {
            "name": n,
            "category": cat.get(n, classify(n)),
            "self_s": round(s, 6),
            "count": count.get(n, 0),
        }
        for n, s in sorted(self_s.items(), key=lambda kv: -kv[1])[:k]
    ]


def _merge_trace(total: dict, tr: dict) -> None:
    total["device_busy_s"] += tr["device_busy_s"]
    for c in CATEGORIES:
        total["categories"][c] += tr["categories"][c]
    for kind, s in tr["collectives"].items():
        total["collectives"][kind] = total["collectives"].get(kind, 0.0) + s
    total["infeed_stall_s"] += tr["infeed_stall_s"]
    for f in ("comm_s", "compute_s", "overlapped_s"):
        total["overlap"][f] += tr["overlap"][f]
    for n, s in tr["_op_self_s"].items():
        total["_op_self_s"][n] = total["_op_self_s"].get(n, 0.0) + s
    for n, c in tr["_op_count"].items():
        total["_op_count"][n] = total["_op_count"].get(n, 0) + c
    total["_op_cat"].update(tr["_op_cat"])


def _finish(total: dict, top_k: int) -> dict:
    comm = total["overlap"]["comm_s"]
    total["overlap"]["overlap_frac"] = (
        round(total["overlap"]["overlapped_s"] / comm, 4) if comm > 0 else None
    )
    for f in ("comm_s", "compute_s", "overlapped_s"):
        total["overlap"][f] = round(total["overlap"][f], 6)
    busy = total["device_busy_s"]
    total["collective_frac"] = (
        round(total["categories"]["collective"] / busy, 4) if busy > 0 else None
    )
    total["top_ops"] = _top_ops(
        total.pop("_op_self_s"), total.pop("_op_count"), total.pop("_op_cat"), top_k
    )
    total["categories"] = {
        c: round(v, 6) for c, v in total["categories"].items()
    }
    # the reported busy is the sum of the ROUNDED categories, so the
    # sum-to-busy invariant survives the 6-decimal rounding exactly
    total["device_busy_s"] = round(sum(total["categories"].values()), 6)
    total["collectives"] = {
        k: round(v, 6) for k, v in sorted(total["collectives"].items())
    }
    total["infeed_stall_s"] = round(total["infeed_stall_s"], 6)
    return total


def _fresh_total() -> dict:
    return {
        "device_busy_s": 0.0,
        "categories": {c: 0.0 for c in CATEGORIES},
        "collectives": {},
        "infeed_stall_s": 0.0,
        "overlap": {"comm_s": 0.0, "compute_s": 0.0, "overlapped_s": 0.0},
        "_op_self_s": {},
        "_op_count": {},
        "_op_cat": {},
    }


def analyze_capture(capture_dir: str, top_k: int = 10) -> dict:
    """The attribution report over every trace file under a capture
    directory (one a rank in a multi-rank capture: their device times
    sum; the overlap fraction is the ratio of summed overlapped to summed
    comm seconds).

    Per-file failures (truncated gzip, torn JSON, no device track) become
    counted entries in ``report["dropped"]`` + ``report["errors"]``: a
    PARTIAL report, never an exception, as long as at least one trace
    analyzes. With nothing analyzable the capture is useless and a typed
    :class:`CaptureError` subclass says why (empty dir vs all-malformed
    vs no-device-track)."""
    if not os.path.isdir(capture_dir):
        raise EmptyCaptureError(f"{capture_dir}: not a directory")
    paths = find_traces(capture_dir)
    if not paths:
        raise EmptyCaptureError(
            f"{capture_dir}: no *.trace.json.gz under it — the capture "
            "wrote nothing (profiler unavailable, or the dir is not a "
            "torch.profiler output)"
        )
    total = _fresh_total()
    traces: List[dict] = []
    errors: List[dict] = []
    dropped = {"malformed_trace": 0, "no_device_track": 0}
    for path in paths:
        try:
            tr = analyze_events(load_trace(path))
        except CaptureError as e:
            dropped[e.kind] = dropped.get(e.kind, 0) + 1
            errors.append({"path": path, "kind": e.kind, "error": str(e)[:300]})
            continue
        _merge_trace(total, tr)
        traces.append({
            "path": path,
            "op_threads": tr["op_threads"],
            "n_op_events": tr["n_op_events"],
            "device_busy_s": round(tr["device_busy_s"], 6),
        })
    if not traces:
        kinds = {e["kind"] for e in errors}
        cls = (
            NoDeviceTrackError if kinds == {"no_device_track"}
            else MalformedTraceError
        )
        raise cls(
            f"{capture_dir}: none of {len(paths)} trace file(s) analyzable "
            f"({'; '.join(e['error'] for e in errors[:3])})"
        )
    report = _finish(total, top_k)
    report.update({
        "capture_dir": capture_dir,
        "n_traces": len(paths),
        "analyzed": len(traces),
        "traces": traces,
        "dropped": {k: v for k, v in dropped.items() if v},
        "errors": errors,
    })
    return report


def analyze_trace_file(path: str, top_k: int = 10) -> dict:
    """Analyze ONE Chrome trace file (``.json`` or ``.json.gz``): the
    offline path for a trace pulled out of a capture by hand."""
    total = _fresh_total()
    tr = analyze_events(load_trace(path))
    _merge_trace(total, tr)
    report = _finish(total, top_k)
    report.update({
        "capture_dir": path, "n_traces": 1, "analyzed": 1,
        "traces": [{"path": path, "op_threads": tr["op_threads"],
                    "n_op_events": tr["n_op_events"]}],
        "dropped": {}, "errors": [],
    })
    return report


# --------------------------------------------------------------------------
# Report shaping: the compact record + the rank-0 line
# --------------------------------------------------------------------------


def compact(report: dict, top_k: int = 3) -> dict:
    """The history-record payload (``profile_analysis``): the category
    split, overlap, collective share and the top few ops, small enough to
    stamp per capture without bloating the JSONL."""
    out = {
        "device_busy_s": report["device_busy_s"],
        "categories": dict(report["categories"]),
        "collectives": dict(report["collectives"]),
        "collective_frac": report.get("collective_frac"),
        "overlap_frac": report["overlap"]["overlap_frac"],
        "comm_s": report["overlap"]["comm_s"],
        "infeed_stall_s": report["infeed_stall_s"],
        "top_ops": [
            {"name": o["name"], "self_s": o["self_s"]}
            for o in report.get("top_ops", [])[:top_k]
        ],
        "analyzed_traces": report.get("analyzed", 1),
    }
    if report.get("dropped"):
        out["dropped"] = dict(report["dropped"])
    return out


def summary_line(report: dict) -> str:
    """One rank-0 line of attribution per capture: the answer a capture
    exists to give, without opening Perfetto. Accepts both the full
    report and the :func:`compact` record shape."""
    busy = report.get("device_busy_s") or 0.0
    cats = report.get("categories") or {}

    def pct(c):
        v = cats.get(c, 0.0)
        return f"{v / busy:.0%}" if busy > 0 else "-"

    colls = report.get("collectives") or {}
    coll_detail = (
        " (" + ", ".join(f"{k} {v:.3f}s" for k, v in colls.items()) + ")"
        if colls else ""
    )
    ov = (report.get("overlap") or {}).get(
        "overlap_frac", report.get("overlap_frac")
    )
    parts = [
        f"device busy {busy:.3f}s:",
        f"matmul/conv {pct('matmul_conv')},",
        f"collectives {pct('collective')}{coll_detail},",
        f"infeed/outfeed {pct('infeed_outfeed')},",
        f"fusion/other {pct('fusion_other')},",
        f"host {pct('host')};",
        f"comm/compute overlap {ov:.0%};" if isinstance(ov, (int, float))
        else "comm/compute overlap -;",
        f"infeed stall {report.get('infeed_stall_s', 0.0):.3f}s",
    ]
    if report.get("dropped"):
        n = sum(report["dropped"].values())
        parts.append(f"({n} trace file(s) dropped)")
    return " ".join(parts)


def format_text(report: dict) -> str:
    """Full human rendering for the ``obs xprof`` CLI."""
    lines = [
        f"capture {report.get('capture_dir')}: "
        f"{report.get('analyzed')}/{report.get('n_traces')} trace file(s) "
        f"analyzed"
    ]
    for e in report.get("errors", []):
        lines.append(f"  DROPPED [{e['kind']}] {e['error']}")
    busy = report["device_busy_s"]
    lines.append(f"device busy: {busy:.6f}s across "
                 f"{sum(t.get('op_threads', 0) for t in report.get('traces', []))} "
                 "op thread(s)")
    lines.append(f"{'category':>16} {'seconds':>12} {'share':>7}")
    for c in CATEGORIES:
        v = report["categories"][c]
        share = f"{v / busy:.1%}" if busy > 0 else "-"
        lines.append(f"{c:>16} {v:>12.6f} {share:>7}")
    if report.get("collectives"):
        lines.append("collectives by kind:")
        for k, v in report["collectives"].items():
            lines.append(f"{k:>16} {v:>12.6f}")
    ov = report["overlap"]
    frac = ov.get("overlap_frac")
    lines.append(
        "comm/compute overlap: "
        + (f"{frac:.1%}" if isinstance(frac, (int, float)) else "-")
        + f" ({ov['overlapped_s']:.6f}s of {ov['comm_s']:.6f}s comm "
        f"overlapped with {ov['compute_s']:.6f}s compute)"
    )
    lines.append(f"infeed stall: {report['infeed_stall_s']:.6f}s")
    if report.get("top_ops"):
        lines.append("top ops by self time:")
        for o in report["top_ops"]:
            lines.append(
                f"  {o['self_s']:>10.6f}s  {o['name']}  "
                f"[{o['category']}] ×{o['count']}"
            )
    return "\n".join(lines)
