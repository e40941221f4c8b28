"""Preemption-graceful shutdown (SIGTERM -> finish the step -> snapshot ->
exit 75): the port's copy of ``tpu_dist/resilience/preemption.py``.

1. :func:`install` swaps in a SIGTERM handler that only sets a flag.
2. The train step carries the flag in its once-a-step metrics all-reduce,
   so every rank reads the same decision at the same step boundary; the
   trainer finishes that step and raises :class:`PreemptedError`.
3. ``Trainer.fit`` catches it as it catches ``KeyboardInterrupt``: the
   emergency snapshot runs, then the error propagates.
4. ``cli/train.py`` maps it to :data:`PREEMPTION_EXIT_CODE`, and
   ``cli/launch.py`` (which forwards its own SIGTERM to every rank) and
   ``cli/distributed_mp.py`` exit with the same code, so an orchestrator
   tells "preempted, resume me" from a failure.

``PreemptedError`` subclasses ``BaseException`` (as ``KeyboardInterrupt``
does), so an ``except Exception`` cannot swallow a shutdown request.
"""

from __future__ import annotations

import signal
import threading

#: Exit code of a preemption-graceful shutdown: 75 is BSD EX_TEMPFAIL
#: ("temporary failure; user is invited to retry"), distinct from a clean
#: exit (0) and from death by an unhandled SIGTERM (128 + 15).
PREEMPTION_EXIT_CODE = 75


class PreemptedError(BaseException):
    """Cooperative shutdown in progress (SIGTERM observed at a step or
    epoch boundary). ``Trainer.fit`` runs the emergency snapshot on the
    way out."""


_REQUESTED = False
_NOT_INSTALLED = object()


def _handler(signum, frame):  # noqa: ARG001 — the signal-handler signature
    # a flag write only: CPython runs Python-level handlers between
    # bytecodes, so this is safe at any point of the interrupted code
    global _REQUESTED
    _REQUESTED = True


def install():
    """Install the cooperative SIGTERM handler; returns a token for
    :func:`restore`. Off the main thread (where CPython forbids
    ``signal.signal``) it changes nothing, and the token is still valid."""
    if threading.current_thread() is not threading.main_thread():
        return _NOT_INSTALLED
    try:
        return signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # non-main interpreter contexts
        return _NOT_INSTALLED


def restore(token) -> None:
    """Undo :func:`install` (pass its return value)."""
    if token is _NOT_INSTALLED:
        return
    signal.signal(signal.SIGTERM, token if token is not None else signal.SIG_DFL)


def requested() -> bool:
    """True once SIGTERM has been observed (sticky until :func:`clear`)."""
    return _REQUESTED


def clear() -> None:
    global _REQUESTED
    _REQUESTED = False
