"""Process-global counter/gauge registry: the port's own copy of
``tpu_dist/obs/counters.py`` (stdlib only, thread-safe).

Host-side subsystems increment named counters (``subsystem.metric``) and
set last-write-wins gauges; :func:`snapshot` returns both merged, with
counters winning a name collision. Nothing here touches the device.
"""

from __future__ import annotations

import threading
from typing import Dict

# RLock, not Lock: a signal handler or a re-entrant caller on the same
# thread must never deadlock against its own snapshot in flight.
_LOCK = threading.RLock()
_COUNTERS: Dict[str, float] = {}
_GAUGES: Dict[str, object] = {}


def inc(name: str, n: float = 1) -> float:
    """Add ``n`` to counter ``name`` (created at 0); returns the new value.
    Counters are monotonic by convention; values that move both ways are
    gauges (:func:`set_gauge`)."""
    with _LOCK:
        v = _COUNTERS.get(name, 0) + n
        _COUNTERS[name] = v
        return v


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
