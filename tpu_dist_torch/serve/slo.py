"""Serving latency stats: streaming histograms and per-phase request
accounting, the port's copy of the stats half of ``tpu_dist/serve/slo.py``.

Histograms use fixed log-spaced buckets (:data:`DEFAULT_EDGES`, 0.1 ms to
~209 s in powers of two), not a sample list: ``observe`` is one bisect
and an increment, and memory is O(buckets). Quantiles come back as upper
bounds (the upper edge of the bucket holding the q-th sample), at most
one bucket (2x) off in the conservative direction. Merging and reading back serialized
histograms, the SLO rules, the history and exporter plumbing and the
offline serve report wait for a later slice.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_dist_torch.obs import counters as counters_lib

#: Fixed log-spaced bucket edges (seconds): 0.1 ms -> ~209 s in powers of
#: two; the JAX package's layout, so records of the two compare.
DEFAULT_EDGES: Tuple[float, ...] = tuple(1e-4 * 2 ** i for i in range(22))

#: Request phases, in pipeline order. ``queue_wait`` is per request
#: (arrival -> its batch starts assembling); the rest are measured per
#: batch and attributed to every request the batch carried.
PHASES: Tuple[str, ...] = (
    "queue_wait", "batch_assembly", "dispatch", "device", "fetch",
)


class LatencyHistogram:
    """Streaming log-bucketed histogram: O(1) observe, O(buckets) memory,
    with exact ``sum``/``count``/``min``/``max`` beside it."""

    __slots__ = ("edges", "counts", "sum", "count", "min", "max")

    def __init__(self, edges: Sequence[float] = DEFAULT_EDGES):
        if list(edges) != sorted(set(edges)):
            raise ValueError("histogram edges must be strictly increasing")
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.counts: List[int] = [0] * (len(self.edges) + 1)  # + overflow
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, seconds: float) -> None:
        v = float(seconds)
        # OpenMetrics bucket semantics: bucket le=edge counts v <= edge
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile_bound(self, q: float) -> Optional[float]:
        """Upper bound on the q-quantile: the upper edge of the bucket
        holding the ceil(q * count)-th sample (the exact ``max`` for the
        overflow bucket). None while empty."""
        if not self.count:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        target = max(1, -(-int(self.count * q * 1e9) // int(1e9)))  # ceil
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                return self.edges[i] if i < len(self.edges) else self.max
        return self.max  # unreachable with consistent counts

    def to_dict(self) -> dict:
        """Compact record form (non-zero buckets only)."""
        return {
            "edges": len(self.edges),
            "buckets": {str(i): c for i, c in enumerate(self.counts) if c},
            "sum": round(self.sum, 9),
            "count": self.count,
            "min": self.min,
            "max": self.max,
        }


class ServeStats:
    """The engine's serving stats: one total-latency and one TTFB
    histogram, one histogram per phase, queue and batch gauges, and the
    availability ledger. Host arithmetic only; :meth:`publish` mirrors the
    scalars into the counter/gauge registry.

    ``deadline_s`` arms availability: a request is good when its total
    latency meets the deadline. Without one every completed request is
    good."""

    def __init__(self, deadline_s: Optional[float] = None,
                 edges: Sequence[float] = DEFAULT_EDGES):
        self.deadline_s = deadline_s
        self.total = LatencyHistogram(edges)
        self.ttfb = LatencyHistogram(edges)
        self.phases: Dict[str, LatencyHistogram] = {
            p: LatencyHistogram(edges) for p in PHASES
        }
        self.submitted = 0
        self.completed = 0
        self.good = 0          # met the deadline (or all, without one)
        self.shed = 0          # refused at admission
        self.batches = 0
        self.padded_slots = 0  # bucket slots carrying padding, summed
        self.occupancy_sum = 0.0  # sum of real/bucket per batch
        self.queue_depth = 0
        self.queue_depth_max = 0

    # -- writes (engine pump loop) ------------------------------------------

    def on_submit(self, depth: int) -> None:
        self.submitted += 1
        self.set_queue_depth(depth)

    def on_shed(self, depth: int) -> None:
        """One request refused at admission. Shed requests never enter
        ``submitted`` or the latency histograms."""
        self.shed += 1
        self.set_queue_depth(depth)

    def set_queue_depth(self, depth: int) -> None:
        self.queue_depth = depth
        self.queue_depth_max = max(self.queue_depth_max, depth)

    def on_batch(self, n_real: int, bucket: int) -> None:
        self.batches += 1
        self.padded_slots += bucket - n_real
        self.occupancy_sum += n_real / bucket

    def on_request_done(
        self, total_s: float, ttfb_s: float, phase_s: Dict[str, float]
    ) -> None:
        self.total.observe(total_s)
        self.ttfb.observe(ttfb_s)
        for p in PHASES:
            self.phases[p].observe(phase_s.get(p, 0.0))
        self.completed += 1
        if self.deadline_s is None or total_s <= self.deadline_s:
            self.good += 1

    # -- reads --------------------------------------------------------------

    def batch_occupancy(self) -> Optional[float]:
        return self.occupancy_sum / self.batches if self.batches else None

    def availability(self) -> Optional[float]:
        return self.good / self.completed if self.completed else None

    def scalars(self, window_s: Optional[float] = None,
                completed_in_window: Optional[int] = None) -> Dict[str, float]:
        """One flat ``serve.*`` metrics window; quantiles are
        :meth:`LatencyHistogram.quantile_bound` upper bounds in ms."""
        out: Dict[str, float] = {
            "serve.requests": self.submitted,
            "serve.completed": self.completed,
            "serve.shed": self.shed,
            "serve.batches": self.batches,
            "serve.queue_depth": self.queue_depth,
            "serve.queue_depth_max": self.queue_depth_max,
        }

        def put(name, v, scale=1.0, digits=6):
            if isinstance(v, (int, float)):
                out[name] = round(v * scale, digits)

        put("serve.latency_p50_ms", self.total.quantile_bound(0.5), 1e3)
        put("serve.latency_p95_ms", self.total.quantile_bound(0.95), 1e3)
        put("serve.latency_p99_ms", self.total.quantile_bound(0.99), 1e3)
        put("serve.ttfb_p50_ms", self.ttfb.quantile_bound(0.5), 1e3)
        put("serve.ttfb_p99_ms", self.ttfb.quantile_bound(0.99), 1e3)
        put("serve.availability", self.availability())
        put("serve.batch_occupancy", self.batch_occupancy())
        if window_s and window_s > 0 and completed_in_window is not None:
            put("serve.requests_per_s", completed_in_window / window_s, 1.0, 3)
        return out

    def publish(self, scalars: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """Mirror the scalar view into the counter/gauge registry."""
        scalars = scalars if scalars is not None else self.scalars()
        for name, v in scalars.items():
            counters_lib.set_gauge(name, v)
        return scalars

    def check_invariants(self) -> List[str]:
        """The drill and test invariants; returns the violations (empty =
        healthy): every histogram's buckets sum to its count, every phase
        saw as many samples as the total, and the phase latencies add up
        to at most the total latency."""
        probs: List[str] = []
        for name, h in (
            [("total", self.total), ("ttfb", self.ttfb)]
            + list(self.phases.items())
        ):
            if sum(h.counts) != h.count:
                probs.append(
                    f"{name}: bucket counts sum to {sum(h.counts)}, "
                    f"count says {h.count}"
                )
            if h.count != self.total.count:
                probs.append(
                    f"{name}: {h.count} sample(s) vs {self.total.count} "
                    "completed requests"
                )
        if self.total.count != self.completed:
            probs.append(
                f"total histogram holds {self.total.count} sample(s), "
                f"{self.completed} requests completed"
            )
        phase_sum = sum(h.sum for h in self.phases.values())
        if phase_sum > self.total.sum + 1e-6 * max(1.0, self.total.sum):
            probs.append(
                f"phase latency sum {phase_sum:.6f}s exceeds total "
                f"latency sum {self.total.sum:.6f}s"
            )
        return probs
