"""Host-side span recorder: the port's copy of ``tpu_dist/obs/spans.py``.

Spans are timed on ``time.perf_counter`` and kept as Chrome trace
complete (``"ph": "X"``) events, which Perfetto and ``chrome://tracing``
nest by interval containment (``{"traceEvents": drain()}`` is a trace
file). While the recorder is enabled, each :func:`span` also opens
a ``torch.profiler.record_function`` range, so a ``torch.profiler``
capture shows the same names on its timeline (this takes the place of
the JAX package's ``jax.profiler.TraceAnnotation`` bridge). A disabled
recorder's :func:`span` returns a shared no-op context. The JAX
package's span-open listener (its flight recorder's tap) and trace-file
export have no user in the port yet and are left out.

Usage::

    spans.enable()
    with spans.span("serve/warmup", buckets=4):
        ...
    events = spans.drain()
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import torch

#: Cap on buffered events; overflow drops new events and counts them.
MAX_EVENTS = 200_000

_LOCK = threading.Lock()
_ENABLED = False
_EVENTS: List[dict] = []
_DROPPED = 0
_T0 = time.perf_counter()


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
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self._range.__exit__(*exc)
        add_event(self.name, self._t0, end - self._t0, **self.args)
        return False


def span(name: str, **args):
    """Context manager timing a host region; free when disabled."""
    if not _ENABLED:
        return _NULL
    return _Span(name, args)


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


def enable() -> None:
    """Arm the recorder with an empty buffer and the clock re-zeroed."""
    global _ENABLED, _DROPPED, _T0
    with _LOCK:
        _EVENTS.clear()
        _DROPPED = 0
    _T0 = time.perf_counter()
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
