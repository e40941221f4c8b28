"""The capacity census: the port's copy of ``tpu_dist/fleet/capacity.py``,
what the elastic supervisor's probe reads.

A run's *allocation* is the number of processes' worth of cards it may
use right now. The channel is one small text file a run holding one
integer, written atomically (temp file + ``os.replace``, as the heartbeat
is) by whoever owns the capacity: the fleet scheduler
(``fleet/scheduler.py``), an outside orchestrator, or a person with
``echo``. The launcher's :class:`~tpu_dist_torch.elastic.supervisor.
CapacityProbe` polls it; a change either way takes the elastic path
(SIGTERM, checkpoint, relaunch with ``--resume`` at the new size).

The format is the JAX package's, so a file either package writes is read
by the other: ``N`` or ``N decision=<id> cause=<cause>``.

The census's order (:func:`make_census`):

1. the allocation file (``--elastic_capacity_file``) when given,
2. ``TPU_DIST_AVAILABLE_PROCS`` in the environment (an orchestrator that
   cannot write files into the run's tree),
3. the default, the original launch size: on a dedicated host the
   preempted cards come back once the preemption ends, so a run nothing
   constrains always wants to grow back to what it asked for.

Standard library only: the launcher reads it before any device exists,
and the scheduler runs where only the files are seen.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Optional

#: The environment override an orchestrator can set for a whole launcher
#: process tree (the census's second source).
CAPACITY_ENV = "TPU_DIST_AVAILABLE_PROCS"


def read_allocation(path: str) -> Optional[int]:
    """The integer in ``path``, or None when the file is absent, empty or
    torn (nobody constrains the run yet). Never raises: the probe must
    degrade to "no answer", not kill the supervisor."""
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return None
    if not text:
        return None
    try:
        return int(text.split()[0])
    except ValueError:
        return None


def read_allocation_meta(path: str) -> dict:
    """The tokens behind the allocation integer: ``{"decision_id":
    int|None, "cause": str|None}``, both None when the file is absent or
    torn or its writer wrote none. Never raises."""
    out = {"decision_id": None, "cause": None}
    try:
        with open(path) as f:
            tokens = f.read().split()
    except OSError:
        return out
    for tok in tokens[1:]:
        if tok.startswith("decision="):
            val = tok[len("decision="):]
            if re.fullmatch(r"[0-9]+", val):
                out["decision_id"] = int(val)
        elif tok.startswith("cause="):
            out["cause"] = tok[len("cause="):] or None
    return out


def write_allocation(
    path: str, n: int,
    decision_id: Optional[int] = None, cause: Optional[str] = None,
) -> None:
    """Publish allocation ``n`` atomically (a concurrent
    :func:`read_allocation` sees the old value or the new one). With
    ``decision_id`` (and ``cause``) the line carries the scheduler's
    tokens, ``N decision=7 cause=serve_breach``; :func:`read_allocation`
    reads only the leading integer."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    line = f"{int(n)}"
    if decision_id is not None:
        line += f" decision={int(decision_id)}"
        if cause:
            line += f" cause={cause}"
    with open(tmp, "w") as f:
        f.write(line + "\n")
    os.replace(tmp, path)


def make_census(
    capacity_file: Optional[str] = None,
    *,
    default: Optional[int] = None,
    env: Optional[dict] = None,
) -> Callable[[], Optional[int]]:
    """The probe's census callable (the order in the module docstring).
    ``env`` stands in for ``os.environ`` in tests; ``default`` is the
    launcher's original ``--nproc``."""
    environ = env if env is not None else os.environ

    def census() -> Optional[int]:
        if capacity_file:
            n = read_allocation(capacity_file)
            if n is not None:
                return n
        raw = (environ.get(CAPACITY_ENV) or "").strip()
        # an ASCII integer only: a garbage value falls through to the
        # default, never crashes the launcher's probe
        if re.fullmatch(r"[+-]?[0-9]+", raw):
            return int(raw)
        return default

    return census
