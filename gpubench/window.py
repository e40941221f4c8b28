"""The measured window: the program's calls dispatched back to back for a
fixed time, each followed by a CUDA event on the stream, and one
``synchronize`` at the end.

Nothing inside reads the device. To keep the host from queueing minutes of
work ahead of the card, a call waits before it is dispatched until the
call :data:`IN_FLIGHT` places back has finished on the device: the device
always holds the running call and the next. The window ends at the
``synchronize`` after the first call dispatched once ``seconds`` have
passed, so a rate is all the work over all the time, and the gap between
two events is one call's time on the device, waits for the host included.
On the CPU, where calls run as they are made, the host's clock stands in
for the events.
"""

from __future__ import annotations

import time

import torch

IN_FLIGHT = 2  # calls dispatched ahead of the device


def measure(system, seconds: float, device) -> dict:
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    losses, marks = [], []
    t0 = time.perf_counter()
    start = mark()
    while True:
        if cuda and len(marks) >= IN_FLIGHT:
            marks[-IN_FLIGHT].synchronize()
        losses.append(system.call(len(marks)))
        marks.append(mark())
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    edges = [start] + marks
    if cuda:
        call_ms = [a.elapsed_time(b) for a, b in zip(edges, edges[1:])]
    else:
        call_ms = [(b - a) * 1e3 for a, b in zip(edges, edges[1:])]
    losses = torch.cat(losses).float().cpu()
    calls = len(marks)
    return {"calls": calls, "steps": len(losses), "images": calls * system.images_per_call,
            "seconds": t1 - t0, "call_ms": call_ms, "losses": losses.tolist(),
            "peak_bytes": peak}
