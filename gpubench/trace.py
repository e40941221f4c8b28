"""The traced sub-window: ``torch.profiler`` over a few steady steps in
the run's own process, after the measured window, reduced to the device's
busy time, its idle gaps and what the host was doing in each.

Only the device's own activity counts as busy: Kineto's ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events, whose union of intervals inside
the sub-window (a ``record_function`` range around the calls and the
``synchronize`` that ends them) is the busy time. An idle gap is named by
the innermost host event (an operator, a runtime call or an annotation)
that was open at its middle. The trace is written to a temporary file,
read back and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

from gpubench import stats

DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
HOST_CATS = frozenset(("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"))
WINDOW = "gpubench.window"
TOP = 10
LOOK_BACK = 256  # host events before a gap's middle searched for one open across it


def capture(fn, device) -> dict:
    """Trace ``fn()`` (the sub-window's calls) on ``device`` and reduce the
    trace (on the CPU it holds no device activity)."""
    from torch.profiler import ProfilerActivity, profile, record_function  # noqa: PLC0415

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events)


def reduce(events: list) -> dict:
    """``{busy_s, window_s, device_ops, idle_gaps}`` of a Chrome trace's
    events (times in microseconds). ``device_ops``: the device operations
    that took the most time inside the window, ``[[name, seconds]]``;
    ``idle_gaps``: idle seconds by what the host was doing, the most
    first."""
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise ValueError(f"{len(win)} '{WINDOW}' ranges in the trace")
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    intervals = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in device]
    by_name = defaultdict(float)
    for e, iv in zip(device, intervals):
        by_name[e["name"]] += stats.busy([iv], lo, hi)
    host = sorted(((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in spans
                   if e.get("cat") in HOST_CATS and e.get("name") != WINDOW))
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for a, b in stats.gaps(intervals, lo, hi):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        open_ = [h for h in host[max(0, i - LOOK_BACK):i] if h[1] >= mid]
        name = min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "(no host event)"
        idle[name] += (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": stats.busy(intervals, lo, hi) / 1e6, "window_s": (hi - lo) / 1e6,
            "device_events": len(device),
            "device_ops": top({k: v / 1e6 for k, v in by_name.items()}),
            "idle_gaps": top(idle)}
