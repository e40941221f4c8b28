"""Serving latency stats and SLO rules: the port's copy of
``tpu_dist/serve/slo.py``.

Histograms use fixed log-spaced buckets (:data:`DEFAULT_EDGES`, 0.1 ms to
~209 s in powers of two), not a sample list: ``observe`` is one bisect
and an increment, memory is O(buckets), and two histograms merge by
adding their buckets. Quantiles come back as upper bounds (the upper
edge of the bucket holding the q-th sample), at most one bucket (2x) off
in the conservative direction. The same buckets render as OpenMetrics
``histogram`` families (``obs/export.py``).

SLO rules are :class:`~tpu_dist_torch.obs.alerts.AlertRule`\\s over the
``serve.*`` metrics, evaluated once a window by the
:class:`~tpu_dist_torch.obs.alerts.AlertEngine`: ``default`` loads
:data:`SLO_BUILTINS`, a ``.toml``/``.json`` spec uses the ``[[rule]]``
grammar of ``obs/alerts.py``. :func:`serve_report` folds a history's
``serve`` and ``alert`` records into the report that ``python -m
tpu_dist_torch.serve report`` prints, as the JAX package's CLI prints it.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_dist_torch.obs import alerts as alerts_lib
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

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold ``other`` in (across ranks or run segments). Refuses
        another bucket layout: re-bucketing would invent a distribution."""
        if other.edges != self.edges:
            raise ValueError(
                f"cannot merge histograms with different bucket layouts "
                f"({len(other.edges)} vs {len(self.edges)} edges)"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        for attr, pick in (("min", min), ("max", max)):
            o = getattr(other, attr)
            if o is not None:
                s = getattr(self, attr)
                setattr(self, attr, o if s is None else pick(s, o))

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

    @classmethod
    def from_dict(cls, d: dict, edges: Sequence[float] = DEFAULT_EDGES) -> "LatencyHistogram":
        """The inverse of :meth:`to_dict`. A bucket index outside the
        layout raises (a foreign record must not write into the overflow
        bucket through a negative index)."""
        if int(d.get("edges", len(DEFAULT_EDGES))) != len(edges):
            raise ValueError(
                f"serialized histogram has {d.get('edges')} edges, "
                f"reader expects {len(edges)}"
            )
        h = cls(edges)
        for i, c in (d.get("buckets") or {}).items():
            i = int(i)
            if not 0 <= i < len(h.counts):
                raise ValueError(
                    f"serialized histogram bucket index {i} out of range "
                    f"(0..{len(h.counts) - 1})"
                )
            h.counts[i] = int(c)
        h.sum = float(d.get("sum", 0.0))
        h.count = int(d.get("count", 0))
        h.min = d.get("min")
        h.max = d.get("max")
        return h

    def to_openmetrics(self) -> dict:
        """What ``export.render(histograms=...)`` takes: cumulative
        ``(le, count)`` pairs ending with ``+Inf``, and ``sum``/``count``."""
        buckets = []
        cum = 0
        for edge, c in zip(self.edges, self.counts):
            cum += c
            buckets.append((format(edge, ".6g"), cum))
        buckets.append(("+Inf", self.count))
        return {"buckets": buckets, "sum": self.sum, "count": self.count}


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

    def histogram_families(self) -> Dict[str, dict]:
        """The exposition's histogram families (total, TTFB, each phase),
        keyed by registry-style names, for ``export.render(histograms=)``."""
        fams = {
            "serve.latency_seconds": self.total.to_openmetrics(),
            "serve.ttfb_seconds": self.ttfb.to_openmetrics(),
        }
        for p, h in self.phases.items():
            fams[f"serve.phase_{p}_seconds"] = h.to_openmetrics()
        return fams

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


# -- SLO rules ---------------------------------------------------------------

#: The built-in serving SLO library (``slo_rules="default"``), the JAX
#: package's rules and thresholds. ``serve_retrace`` watches
#: ``compile.retraces``, which the port never counts (eager PyTorch
#: compiles nothing per shape): it loads and never fires.
SLO_BUILTINS: Dict[str, alerts_lib.AlertRule] = {
    r.name: r
    for r in (
        alerts_lib.AlertRule("slo_p99_high", "serve.latency_p99_ms", ">",
                             500.0, sustain=2, cooldown=3),
        alerts_lib.AlertRule("slo_p50_high", "serve.latency_p50_ms", ">",
                             100.0, sustain=2, cooldown=3),
        alerts_lib.AlertRule("slo_ttfb_high", "serve.ttfb_p99_ms", ">",
                             250.0, sustain=2, cooldown=3),
        alerts_lib.AlertRule("slo_availability_low", "serve.availability",
                             "<", 0.999, sustain=1, cooldown=3),
        alerts_lib.AlertRule("slo_rps_low", "serve.requests_per_s", "<",
                             1.0, sustain=2, cooldown=3),
        alerts_lib.AlertRule("slo_queue_deep", "serve.queue_depth", ">",
                             64.0, sustain=2, cooldown=3),
        alerts_lib.AlertRule("serve_retrace", "compile.retraces", ">",
                             0.0, sustain=1, cooldown=1, delta=True),
    )
}


def load_slo_rules(spec: str) -> List[alerts_lib.AlertRule]:
    """A ``--slo_rules`` value -> a validated rule list: ``default`` loads
    :data:`SLO_BUILTINS`; otherwise a ``.toml``/``.json`` path in the
    ``[[rule]]`` grammar, where ``builtin =`` resolves against the
    training and serving libraries both."""
    if spec in ("default", "builtin"):
        return list(SLO_BUILTINS.values())
    return alerts_lib.load_rules(
        spec, builtins={**alerts_lib.BUILTIN_RULES, **SLO_BUILTINS}
    )


def make_slo_engine(rules: List[alerts_lib.AlertRule]) -> alerts_lib.AlertEngine:
    """The alert engine over the serve windows, its delta rules seeded
    from the registry now."""
    eng = alerts_lib.AlertEngine(rules)
    eng.seed_deltas(counters_lib.snapshot())
    return eng


# -- the offline serve report (``python -m tpu_dist_torch.serve report``) ----


def serve_report(records: List[dict]) -> dict:
    """Fold a history's ``serve`` records into one report: the window
    table, the last window's scalars, the alerts that fired on serve
    metrics and the run's latency histogram."""
    windows = [
        r for r in records
        if r.get("kind") == "serve" and not r.get("event")
    ]
    alerts = [
        r for r in records
        if r.get("kind") == "alert"
        and str(r.get("metric", "")).startswith("serve.")
    ]
    last = windows[-1] if windows else {}
    total = LatencyHistogram()
    for w in windows:
        h = w.get("latency_hist")
        if isinstance(h, dict):
            try:
                # windows carry cumulative histograms: the last one that
                # parses is the run's (merging them would count twice)
                total = LatencyHistogram.from_dict(h)
            except (ValueError, TypeError, KeyError):
                continue
    return {
        "n_windows": len(windows),
        "windows": windows,
        "alerts": alerts,
        "last": {
            k: last.get(k)
            for k in ("requests", "completed", "requests_per_s",
                      "latency_p50_ms", "latency_p95_ms", "latency_p99_ms",
                      "ttfb_p50_ms", "ttfb_p99_ms", "availability",
                      "batch_occupancy", "queue_depth_max", "retraces")
            if last.get(k) is not None
        },
        "latency_hist": total.to_dict() if total.count else None,
    }


def window_table_lines(windows: List[dict]) -> List[str]:
    """The serve-window table: a header, one row a window, and a warning
    line under a window that counted retraces."""
    lines = [
        f"{'window':>7} {'req/s':>8} {'p50_ms':>8} {'p99_ms':>8} "
        f"{'ttfb99':>8} {'avail':>7} {'occup':>6} {'queue':>6} {'compl':>6}"
    ]

    def fmt(v, spec, width):
        return (format(v, spec) if isinstance(v, (int, float)) else "-").rjust(width)

    for i, w in enumerate(windows):
        lines.append(
            f"{i:>7} {fmt(w.get('requests_per_s'), '.1f', 8)} "
            f"{fmt(w.get('latency_p50_ms'), '.2f', 8)} "
            f"{fmt(w.get('latency_p99_ms'), '.2f', 8)} "
            f"{fmt(w.get('ttfb_p99_ms'), '.2f', 8)} "
            f"{fmt(w.get('availability'), '.3f', 7)} "
            f"{fmt(w.get('batch_occupancy'), '.2f', 6)} "
            f"{fmt(w.get('queue_depth_max'), 'd', 6)} "
            f"{fmt(w.get('completed'), 'd', 6)}"
        )
        if w.get("retraces"):
            lines.append(
                f"      WARNING: {w['retraces']:g} mid-serve retrace(s) "
                "— a batch escaped the bucket ladder"
            )
    return lines


def format_report_text(report: dict) -> str:
    """The report as text: a title, the window table, one line a fired
    SLO alert and the last window's scalars."""
    lines = [
        f"serve report — {report['n_windows']} window(s), "
        f"{len(report['alerts'])} SLO alert(s)"
    ]
    if not report["n_windows"]:
        return lines[0] + " (no serve records — not a serving log?)"
    lines.extend(window_table_lines(report["windows"]))
    for a in report["alerts"]:
        lines.append(
            f"  SLO ALERT {a.get('rule')}: {a.get('metric')} "
            f"{a.get('value')} {a.get('op')} {a.get('threshold')} "
            f"(sustained {a.get('sustained')} window(s))"
        )
    last = report.get("last") or {}
    if last:
        lines.append(
            "final: "
            + ", ".join(f"{k}={v}" for k, v in sorted(last.items()))
        )
    return "\n".join(lines)
