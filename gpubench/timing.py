"""A call's time on the card alone, from CUDA events.

The method of ``tpu_dist_torch/obs/timing.py::device_ms``, frozen here so
that a change to the program cannot change how it is measured: the device
first sleeps for twice the time the host needs to enqueue every call, so
the events around the calls see device time only. A reading in which the
device reached the first call before the host had queued the last is
thrown away and taken again.
"""

from __future__ import annotations

import time

import torch


def _host_ms(fn, iters: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms


def _cycles_per_ms() -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    cycles = 4_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def device_seconds(fn, iters: int = 20, warmup: int = 3, attempts: int = 3) -> float:
    """Seconds of device time a call of ``fn`` takes, over ``iters``
    back-to-back calls behind a head start, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_ms = _cycles_per_ms()
    for _ in range(attempts):
        sleep_ms = 2 * _host_ms(fn, iters) + 1.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(int(sleep_ms * per_ms))
        start.record()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        reached = start.query()
        end.record()
        end.synchronize()
        if not (reached or queued_ms >= sleep_ms):
            return start.elapsed_time(end) / iters / 1e3
    raise RuntimeError(f"the host needed {queued_ms:.3f} ms to enqueue {iters} calls behind a "
                       f"{sleep_ms:.3f} ms head start, {attempts} times")
