"""Process-global counter/gauge registry: the port's own copy of
``tpu_dist/obs/counters.py`` (stdlib only, thread-safe).

Host-side subsystems increment named counters (``subsystem.metric``) and
set last-write-wins gauges; :func:`snapshot` returns both merged, with
counters winning a name collision. Nothing here touches the device.

A CUDA graph runs the Python of the step it holds once, at capture, and
none at its replays. Inside :func:`deferred` the increments are collected
instead of applied, so that whoever replays the graph adds them once a
replay (:func:`add_all`) and a counter still reads one a step.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

# RLock, not Lock: a signal handler or a re-entrant caller on the same
# thread must never deadlock against its own snapshot in flight.
_LOCK = threading.RLock()
_COUNTERS: Dict[str, float] = {}
_GAUGES: Dict[str, object] = {}
_DEFERRED: Optional[Dict[str, float]] = None  # the open deferral's increments


def inc(name: str, n: float = 1) -> float:
    """Add ``n`` to counter ``name`` (created at 0); returns the new value.
    Counters are monotonic by convention; values that move both ways are
    gauges (:func:`set_gauge`)."""
    with _LOCK:
        if _DEFERRED is not None:
            _DEFERRED[name] = _DEFERRED.get(name, 0) + n
            return _COUNTERS.get(name, 0)
        v = _COUNTERS.get(name, 0) + n
        _COUNTERS[name] = v
        return v


@contextlib.contextmanager
def deferred() -> Iterator[Dict[str, float]]:
    """Collect every increment made inside the block, by any thread (the
    autograd engine runs a CUDA backward on threads of its own), into the
    yielded dict instead of the counters. Deferrals do not nest."""
    global _DEFERRED
    with _LOCK:
        if _DEFERRED is not None:
            raise RuntimeError("counters.deferred() is already open")
        _DEFERRED = out = {}
    try:
        yield out
    finally:
        with _LOCK:
            _DEFERRED = None


def add_all(increments: Dict[str, float]) -> None:
    """Apply the increments a :func:`deferred` block collected."""
    for name, n in increments.items():
        inc(name, n)


def set_gauge(name: str, value: object) -> None:
    """Last-write-wins gauge (a number or a short JSON-serializable string)."""
    with _LOCK:
        _GAUGES[name] = value


def get(name: str, default: float = 0) -> float:
    with _LOCK:
        return _COUNTERS.get(name, default)


def snapshot() -> Dict[str, object]:
    """One consistent flat copy of counters and gauges."""
    with _LOCK:
        out: Dict[str, object] = dict(_GAUGES)
        out.update(_COUNTERS)
        return out


def reset() -> None:
    """Clear everything: test isolation and the start of a fresh run."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
