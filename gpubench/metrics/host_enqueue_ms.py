"""The host time one step's call takes to return when started on an idle
device: a ``synchronize`` before the call, none inside it; the mean over
``enqueue_steps`` such steps after the window. Where it nears the step's
device time, the host sets the pace."""

import time

import torch


def read(run):
    system = run.system
    if system.steps_per_call != 1 or run.device.type != "cuda":
        return None
    total = 0.0
    n = run.traffic["enqueue_steps"]
    for i in range(n):
        torch.cuda.synchronize(run.device)
        t0 = time.perf_counter()
        system.call(i)
        total += time.perf_counter() - t0
    torch.cuda.synchronize(run.device)
    return 1e3 * total / n
