"""Times on the card, the device's apart from the host's.

Two events around back-to-back calls read the slower of two paces: the
device's, or the host's when it needs longer to enqueue a call than the
device needs to run it. :func:`device_ms` gives the device a head start
instead: it queues a ``torch.cuda._sleep`` first, so the host has enqueued
every call before the device reaches the first one, and the events then
see device time only. It raises when the host did not finish in time.
:func:`host_us` is the host's time to enqueue one call.
"""

from __future__ import annotations

import time

import torch


class HeadStartError(RuntimeError):
    """The host was still enqueueing when the device reached the first call."""


def host_us(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean host microseconds to enqueue one call of ``fn``: ``perf_counter``
    around ``iters`` calls with no synchronise, after ``warmup`` calls and a
    synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def cycles_per_ms() -> float:
    """SM clock cycles in a millisecond, from events around one
    ``torch.cuda._sleep`` (which spins for a count of cycles)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    cycles = 4_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn, iters: int = 50, warmup: int = 5, head_start: bool = True,
              attempts: int = 3):
    """``(device ms a call, host us a call)`` of ``fn`` over ``iters`` calls
    after ``warmup``; inputs stay L2-warm, as when the model produces them
    just before.

    With ``head_start`` the device sleeps first for twice the measured
    enqueue time of the ``iters`` calls plus 1 ms. If the host's clock or
    the start event shows that the device reached the first call before
    the host had queued the last (a stall of the host), that reading is
    thrown away and taken again, the enqueue time measured anew, up to
    ``attempts`` readings; the last late one raises
    :class:`HeadStartError`. Without it (for a function of thousands of
    launches, which would fill the launch queue while the device sleeps),
    the events read the period of back-to-back calls: the host's pace where
    that is slower."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if not head_start:
        enqueue_us = host_us(fn, iters, warmup)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters, enqueue_us
    for attempt in range(attempts):
        enqueue_us = host_us(fn, iters, warmup)
        sleep_ms = 2 * enqueue_us * iters / 1e3 + 1.0
        cycles = int(sleep_ms * cycles_per_ms())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        reached = start.query()  # the sleep is over: the device may have begun
        end.record()
        end.synchronize()
        if not (reached or queued_ms >= sleep_ms):
            return start.elapsed_time(end) / iters, enqueue_us
    raise HeadStartError(
        f"the host took {queued_ms:.3f} ms to enqueue {iters} calls behind a "
        f"{sleep_ms:.3f} ms head start in the last of {attempts} readings (the device had "
        f"{'reached' if reached else 'not reached'} the first call)")


def profile_device(fn, iters: int = 10) -> dict:
    """``{name: (count, device microseconds in all)}`` of every kernel and
    copy that ``iters`` calls of ``fn`` put on the card, from
    ``torch.profiler`` (its rows whose device type is CUDA)."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            rows[e.key] = (e.count, us)
    return rows
