"""The inference path: continuous batching over one eager forward, with
per-request latency split into phases. Counterpart of
``tpu_dist/serve/engine.py``.

* Batches are padded to a power-of-two bucket (``1, 2, 4, ...,
  max_batch``), as in the JAX engine, and :meth:`ServingEngine.warmup`
  runs every bucket once with host numpy zeros, the same path the pump
  takes.
* Every request's life is split into the ``slo.PHASES`` on the engine's
  injectable clock. On CUDA, ``dispatch`` is the host time to copy the
  batch to the card and enqueue the forward, ``device`` ends at
  ``torch.cuda.synchronize()`` (the JAX engine's ``block_until_ready``),
  and ``fetch`` is the copy back to numpy. On the CPU the forward runs
  inside ``dispatch`` and ``device`` is ~0.

The JAX engine's ``CompileWatcher`` retrace accounting has no
counterpart here: eager PyTorch compiles nothing per shape, so there is
no retrace to count. The checkpoint restore ladder
(``load_serving_state``), int8 weight quantization, SLO rules, history,
exporter and heartbeat arguments wait for later slices and are absent.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_dist_torch import resolve_device
from tpu_dist_torch.obs import counters as counters_lib
from tpu_dist_torch.obs import spans as spans_lib
from tpu_dist_torch.serve import slo as slo_lib


def batch_buckets(max_batch: int) -> Tuple[int, ...]:
    """The power-of-two bucket ladder ``(1, 2, 4, ..., max_batch)``;
    ``max_batch`` must itself be a power of two."""
    if max_batch < 1 or max_batch & (max_batch - 1):
        raise ValueError(
            f"max_batch must be a power of two (the bucket ladder), "
            f"got {max_batch}"
        )
    out = []
    b = 1
    while b <= max_batch:
        out.append(b)
        b *= 2
    return tuple(out)


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket holding ``n`` requests."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the top bucket {buckets[-1]}")


class Request:
    """One in-flight inference request. ``arrival_s`` is on the engine's
    clock; the pump fills in the result and the phase timings."""

    __slots__ = (
        "id", "payload", "arrival_s", "result", "ok",
        "total_s", "ttfb_s", "phase_s",
    )

    def __init__(self, id, payload: np.ndarray, arrival_s: float):
        self.id = id
        self.payload = payload
        self.arrival_s = arrival_s
        self.result: Optional[np.ndarray] = None
        self.ok = False
        self.total_s: Optional[float] = None
        self.ttfb_s: Optional[float] = None
        self.phase_s: Dict[str, float] = {}


class ServingEngine:
    """Continuous-batching inference over ``model`` (an ``nn.Module``
    mapping a float batch ``[B, ...]`` to logits ``[B, classes]``).

    Single-threaded: callers :meth:`submit` requests and drive
    :meth:`pump`, which runs the longest-waiting requests as one
    bucket-padded batch and completes them with their phase latencies.
    :meth:`record_window` closes an observation window and publishes the
    ``serve.*`` scalars as gauges. ``clock`` is any ``() -> float``
    monotonic source (default ``time.perf_counter``)."""

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        max_batch: int = 8,
        deadline_s: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
        max_queue: Optional[int] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.buckets = batch_buckets(max_batch)
        self.max_batch = max_batch
        self._clock = clock or time.perf_counter
        self._queue: collections.deque = collections.deque()
        self.stats = slo_lib.ServeStats(deadline_s=deadline_s)
        # admission control: while shedding, or at the queue cap, submit()
        # refuses instead of queueing
        self.max_queue = max_queue
        self._shedding = False
        self._seq = 0
        self._window_start = self._clock()
        self._window_completed_at = 0  # stats.completed at window open
        counters_lib.set_gauge("serve.max_batch", max_batch)
        counters_lib.set_gauge("serve.device", str(self.device))

    # -- the forward, in its phases ------------------------------------------

    def _dispatch(self, batch: np.ndarray) -> torch.Tensor:
        """Copy a host batch to the device and enqueue the forward."""
        counters_lib.inc("serve.forwards")
        return self.model(torch.from_numpy(batch).to(self.device))

    def _wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- lifecycle ----------------------------------------------------------

    def warmup(self, sample_shape: Tuple[int, ...]) -> int:
        """Run every bucket once with host numpy zeros, the same path the
        pump takes (lazy CUDA set-up, kernel builds and allocator growth
        land here, not on the first requests). ``sample_shape`` is one
        request's payload shape, e.g. ``(H, W, C)``, in float32. Returns
        the number of buckets run."""
        t0 = self._clock()
        with torch.inference_mode():
            for b in self.buckets:
                self._dispatch(np.zeros((b,) + tuple(sample_shape), np.float32))
                self._wait()
        dur = self._clock() - t0
        spans_lib.add_event("serve/warmup", t0, dur, buckets=len(self.buckets))
        counters_lib.set_gauge("serve.warmup_s", round(dur, 3))
        counters_lib.inc("serve.warmup_forwards", len(self.buckets))
        return len(self.buckets)

    # -- request flow -------------------------------------------------------

    def set_shedding(self, on: bool) -> None:
        """Toggle load shedding: while on, :meth:`submit` refuses new
        requests and the pump keeps draining what was admitted."""
        self._shedding = bool(on)
        counters_lib.set_gauge("serve.shedding", 1 if on else 0)

    @property
    def shedding(self) -> bool:
        return self._shedding

    def submit(self, payload: np.ndarray, *, id=None,
               arrival_s: Optional[float] = None) -> Request:
        """Enqueue one request (``payload`` is one sample, no batch dim;
        ``arrival_s`` overrides the clock reading).

        While shedding, or with ``max_queue`` requests already queued, the
        request is refused: returned at once with ``ok`` False, counted as
        ``serve.shed``, kept out of the queue and the latency histograms."""
        self._seq += 1
        req = Request(
            id if id is not None else self._seq,
            np.asarray(payload),
            self._clock() if arrival_s is None else arrival_s,
        )
        if self._shedding or (
            self.max_queue is not None and len(self._queue) >= self.max_queue
        ):
            self.stats.on_shed(len(self._queue))
            counters_lib.inc("serve.shed")
            return req
        self._queue.append(req)
        self.stats.on_submit(len(self._queue))
        counters_lib.inc("serve.requests")
        return req

    def queue_depth(self) -> int:
        return len(self._queue)

    @torch.inference_mode()
    def pump(self) -> List[Request]:
        """Assemble and run one batch from the queue head (an empty queue
        is a no-op). Returns the completed requests."""
        if not self._queue:
            return []
        t_assemble = self._clock()
        take = min(len(self._queue), self.max_batch)
        reqs = [self._queue.popleft() for _ in range(take)]
        bucket = bucket_for(take, self.buckets)
        batch = np.zeros((bucket,) + reqs[0].payload.shape,
                         reqs[0].payload.dtype)
        for i, r in enumerate(reqs):
            batch[i] = r.payload
        self.stats.on_batch(take, bucket)
        self.stats.set_queue_depth(len(self._queue))
        counters_lib.inc("serve.batches")
        counters_lib.inc("serve.batch_requests", take)

        t_dispatch = self._clock()
        out = self._dispatch(batch)
        t_dispatched = self._clock()
        self._wait()
        t_device = self._clock()
        logits = out.cpu().numpy()
        t_fetch = self._clock()

        spans_lib.add_event("serve/batch_assembly", t_assemble,
                            t_dispatch - t_assemble, n=take, bucket=bucket)
        spans_lib.add_event("serve/dispatch", t_dispatch,
                            t_dispatched - t_dispatch)
        spans_lib.add_event("serve/device", t_dispatched,
                            t_device - t_dispatched)
        spans_lib.add_event("serve/fetch", t_device, t_fetch - t_device)

        for i, r in enumerate(reqs):
            r.result = logits[i]
            r.ok = True
            # a future-dated arrival clamps to the assembly instant for
            # every phase alike, so the phases still partition the total
            arrival = min(r.arrival_s, t_assemble)
            r.phase_s = {
                "queue_wait": t_assemble - arrival,
                "batch_assembly": t_dispatch - t_assemble,
                "dispatch": t_dispatched - t_dispatch,
                "device": t_device - t_dispatched,
                "fetch": t_fetch - t_device,
            }
            r.total_s = t_fetch - arrival
            # TTFB: arrival -> the device accepted the work
            r.ttfb_s = t_dispatched - arrival
            self.stats.on_request_done(r.total_s, r.ttfb_s, r.phase_s)
        counters_lib.inc("serve.completed", take)
        return reqs

    def drain(self, max_pumps: int = 10_000) -> List[Request]:
        """Pump until the queue empties; returns everything completed."""
        done: List[Request] = []
        for _ in range(max_pumps):
            if not self._queue:
                break
            done.extend(self.pump())
        return done

    # -- observation windows -------------------------------------------------

    def record_window(self) -> Dict[str, float]:
        """Close one observation window: compute the ``serve.*`` scalars
        (requests/s over this window), publish them as registry gauges and
        return them."""
        now = self._clock()
        window_s = max(now - self._window_start, 1e-9)
        completed = self.stats.completed - self._window_completed_at
        scalars = self.stats.scalars(
            window_s=window_s, completed_in_window=completed
        )
        self.stats.publish(scalars)
        self._window_start = now
        self._window_completed_at = self.stats.completed
        return scalars
