"""Host-side span recorder: the port's copy of ``tpu_dist/obs/spans.py``.

Spans are timed on ``time.perf_counter`` and kept as Chrome trace
complete (``"ph": "X"``) events, which Perfetto and ``chrome://tracing``
nest by interval containment (``{"traceEvents": drain()}`` is a trace
file). While the recorder is enabled, each :func:`span` also opens
a ``torch.profiler.record_function`` range, so a ``torch.profiler``
capture shows the same names on its timeline (this takes the place of
the JAX package's ``jax.profiler.TraceAnnotation`` bridge). A disabled
recorder's :func:`span` returns a shared no-op context, unless a span-open
listener is set (:func:`set_open_listener`, the flight recorder's tap):
then every span open calls it, on every rank, buffering nothing.
:func:`export_chrome_trace` writes the buffer (and events drained before)
as one trace file, the trainer's ``--trace_file``.

Usage::

    spans.enable()
    with spans.span("serve/warmup", buckets=4):
        ...
    events = spans.drain()
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

import torch

#: Cap on buffered events; overflow drops new events and counts them.
MAX_EVENTS = 200_000

_LOCK = threading.Lock()
_ENABLED = False
_EVENTS: List[dict] = []
_DROPPED = 0
_T0 = time.perf_counter()
_OPEN_LISTENER = None  # fn(name, args), called at every span open


class _NullSpan:
    """Shared do-nothing context for the disabled recorder."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "_t0", "_range")

    def __init__(self, name: str, args: Dict[str, object]):
        self.name = name
        self.args = args
        self._range = None

    def __enter__(self):
        lis = _OPEN_LISTENER
        if lis is not None:
            lis(self.name, self.args)
        if _ENABLED:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
        add_event(self.name, self._t0, end - self._t0, **self.args)
        return False


def span(name: str, **args):
    """Context manager timing a host region. Free when disabled (a span
    that only tells the open listener is made when one is set)."""
    if not _ENABLED and _OPEN_LISTENER is None:
        return _NULL
    return _Span(name, args)


def set_open_listener(fn) -> None:
    """Arm the span-open tap (one a process; the trainer and the serving
    replica point it at their flight recorder): ``fn(name, args)`` is
    called at every span open, enabled or not."""
    global _OPEN_LISTENER
    _OPEN_LISTENER = fn


def clear_open_listener() -> None:
    global _OPEN_LISTENER
    _OPEN_LISTENER = None


def add_event(name: str, t_start: float, duration: float, **args) -> None:
    """Record an already-timed region (``t_start`` from
    ``time.perf_counter()``), for call sites that time their phases anyway."""
    global _DROPPED
    if not _ENABLED:
        return
    evt = {
        "name": name,
        "ph": "X",
        "ts": round((t_start - _T0) * 1e6, 1),  # Chrome traces are in us
        "dur": round(duration * 1e6, 1),
        "pid": 0,
        "tid": threading.get_ident() & 0x7FFFFFFF,
    }
    if args:
        evt["args"] = args
    with _LOCK:
        if len(_EVENTS) >= MAX_EVENTS:
            _DROPPED += 1
            return
        _EVENTS.append(evt)


def enable(fresh: bool = True, origin: Optional[float] = None) -> None:
    """Arm the recorder with an empty buffer and the clock zeroed now, or at
    ``origin`` (an earlier ``time.perf_counter()`` reading: the trainer's
    construction, its history's ``rel_s`` origin); ``fresh=False`` re-arms
    it keeping the buffer and the clock origin (a second ``fit`` continues
    the timeline of the first)."""
    global _ENABLED, _DROPPED, _T0
    if fresh:
        with _LOCK:
            _EVENTS.clear()
            _DROPPED = 0
        _T0 = time.perf_counter() if origin is None else origin
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def events() -> List[dict]:
    """Copy of the buffered events (oldest first)."""
    with _LOCK:
        return list(_EVENTS)


def dropped() -> int:
    with _LOCK:
        return _DROPPED


def drain() -> List[dict]:
    """Return and clear the buffer."""
    with _LOCK:
        out = list(_EVENTS)
        _EVENTS.clear()
        return out


def to_chrome_trace(extra_events: Optional[List[dict]] = None) -> dict:
    """The Perfetto/chrome://tracing JSON object for the buffered (plus any
    caller-supplied, placed first) events; the count of dropped events
    rides in ``metadata``."""
    evts = events()
    if extra_events:
        evts = extra_events + evts
    out = {"traceEvents": evts, "displayTimeUnit": "ms"}
    d = dropped()
    if d:
        out["metadata"] = {"tpu_dist_dropped_events": d}
    return out


def export_chrome_trace(path: str, extra_events: Optional[List[dict]] = None) -> str:
    """Write :func:`to_chrome_trace`'s JSON to ``path``; returns the path.
    The caller owns the rank-0 guard (the trainer exports on rank 0)."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(extra_events), f)
    return path
