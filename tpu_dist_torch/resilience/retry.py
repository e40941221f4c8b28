"""Exponential-backoff retry for transient host I/O: the port's copy of
``tpu_dist/resilience/retry.py`` (``backoff_delays``, ``retry_call``).

Only host-side, idempotent operations: the checkpoint writers, whose
write-to-temp + atomic rename leaves nothing behind when an attempt fails.
Collectives are out of scope (a retried collective on one rank deadlocks
the others).

The delay sequence is ``base_delay * 2**attempt`` capped at ``max_delay``:
a pure function of the attempt index, no jitter and no clock, and the
sleep is injectable, so tests assert the exact schedule without sleeping.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type

from tpu_dist_torch.metrics.logging import rank0_print
from tpu_dist_torch.obs import counters


def backoff_delays(
    retries: int, base_delay: float = 0.05, max_delay: float = 2.0
) -> Tuple[float, ...]:
    """The deterministic sleep schedule: one entry per retry."""
    return tuple(min(base_delay * (2.0 ** i), max_delay) for i in range(max(0, retries)))


def retry_call(
    fn: Callable,
    *args,
    retries: int = 0,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    sleep: Optional[Callable[[float], None]] = None,
    describe: str = "",
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``; on a ``retry_on`` exception, sleep the
    next backoff delay and try again, up to ``retries`` extra attempts.
    The last failure re-raises the exception itself, not a wrapper."""
    if retries <= 0:
        return fn(*args, **kwargs)
    do_sleep = sleep if sleep is not None else time.sleep
    for attempt, delay in enumerate(backoff_delays(retries, base_delay, max_delay)):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            counters.inc("io.retries")
            rank0_print(
                f"WARNING: transient {describe or 'I/O'} failure (attempt "
                f"{attempt + 1}/{retries + 1}): {e} — retrying in {delay:g}s"
            )
            do_sleep(delay)
    return fn(*args, **kwargs)  # the last attempt: errors propagate
