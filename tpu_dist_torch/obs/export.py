"""Live OpenMetrics exposition of the counter/gauge registry: the port's
copy of ``tpu_dist/obs/export.py`` (``metric_name``, ``render``,
``parse``, ``MetricsExporter``, ``active_labels``, ``KEY_GAUGES``,
``key_gauges``, ``scrape``).

The registry snapshot, labelled gauges (``alert_active{rule="..."}``)
and histogram families (the serving latencies) are rendered as
OpenMetrics text and published two ways: a textfile written atomically
(temp file + ``os.replace``) at most once a ``min_interval``, and an
HTTP ``GET /metrics`` served by a background thread from the last
rendered bytes (the handler never reads the registry or the model).
Every name is prefixed ``tpu_dist_`` and sanitized to the OpenMetrics
grammar (``serve.latency_p99_ms`` -> ``tpu_dist_serve_latency_p99_ms``),
the JAX package's names, so one scraper reads both. Stdlib only.
"""

from __future__ import annotations

import os
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from tpu_dist_torch.obs import counters

#: Exposition content type (Prometheus accepts both; OpenMetrics scrapers
#: negotiate this one).
CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

#: Every exported family is prefixed so a shared Prometheus never
#: collides with another job's namespace.
PREFIX = "tpu_dist_"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def metric_name(raw: str) -> str:
    """Registry name → OpenMetrics family name (``ckpt.bytes_written`` →
    ``tpu_dist_ckpt_bytes_written``)."""
    name = PREFIX + _SANITIZE.sub("_", raw)
    if not _NAME_OK.match(name):  # leading digit after the prefix etc.
        name = PREFIX + "_" + _SANITIZE.sub("_", raw)
    return name


def _fmt_value(v: float) -> str:
    """OpenMetrics number rendering: integers without a trailing ``.0``
    (counter semantics read better), floats with repr precision."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))


def render(
    values: Dict[str, float],
    labeled: Optional[Dict[str, Dict[str, float]]] = None,
    label_keys: Optional[Dict[str, str]] = None,
    histograms: Optional[Dict[str, dict]] = None,
) -> str:
    """Render one exposition: ``values`` maps raw (dotted) metric names to
    numbers; ``labeled`` maps raw names to ``{label_value: number}``
    samples emitted as ``name{<key>="..."}`` — the label key per family
    comes from ``label_keys`` and defaults to ``rule`` (the alert gauges,
    the original labeled family).
    ``histograms`` maps raw names to the OpenMetrics ``histogram`` shape
    (``{"buckets": [(le, cumulative_count), ...], "sum": s, "count": n}``
    — ``serve/slo.py::LatencyHistogram.to_openmetrics``), emitted as
    ``name_bucket{le="..."}`` / ``name_sum`` / ``name_count`` so a
    Prometheus computes real ``histogram_quantile()``s over the serving
    latencies; the bucket list must already be cumulative and end with
    ``+Inf`` (the producer's contract — this renderer is a formatter,
    not a validator). Non-numeric registry entries (info gauges — run
    id, mode strings) are skipped: OpenMetrics samples are numbers.
    Ends with the mandatory ``# EOF``."""
    lines = []
    for raw in sorted(values):
        v = values[raw]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        name = metric_name(raw)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt_value(v)}")
    for raw in sorted(labeled or {}):
        name = metric_name(raw)
        key = (label_keys or {}).get(raw, "rule")
        lines.append(f"# TYPE {name} gauge")
        for label, v in sorted((labeled or {})[raw].items()):
            safe = str(label).replace("\\", "\\\\").replace('"', '\\"')
            lines.append(f'{name}{{{key}="{safe}"}} {_fmt_value(v)}')
    for raw in sorted(histograms or {}):
        fam = (histograms or {})[raw]
        name = metric_name(raw)
        lines.append(f"# TYPE {name} histogram")
        for le, cum in fam.get("buckets") or []:
            lines.append(f'{name}_bucket{{le="{le}"}} {_fmt_value(cum)}')
        lines.append(f"{name}_sum {_fmt_value(float(fam.get('sum', 0.0)))}")
        lines.append(f"{name}_count {_fmt_value(int(fam.get('count', 0)))}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def parse(text: str) -> Dict[str, float]:
    """Minimal exposition parser: reads back what :func:`render` wrote
    (a watchdog's scrape, the tests).  Returns
    ``{name_or_name{labels}: value}`` with the ``tpu_dist_`` prefix kept
    (names are compared against :func:`metric_name` output)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.rsplit(" ", 1)
        if len(parts) != 2:
            continue
        try:
            out[parts[0]] = float(parts[1])
        except ValueError:
            continue
    return out


class _Handler(BaseHTTPRequestHandler):
    server_version = "tpu-dist-metrics/1"

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        body = self.server.exporter_body()  # type: ignore[attr-defined]
        counters.inc("export.scrapes")
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr lines
        pass


class MetricsExporter:
    """One publisher per process (the serving engine's ``exporter``).

    ``update(values, labeled, force=...)`` renders the exposition and
    (a) rewrites the textfile atomically unless inside the throttle
    window, (b) swaps the snapshot the HTTP thread serves.  ``rank``
    guards the endpoint: a non-zero rank asking for a port is refused at
    construction (one pod-visible endpoint per run), while the textfile
    works on any rank — its path is the caller's to derive. ``host`` is
    the address the endpoint binds (all interfaces by default, as the JAX
    exporter binds; ``"127.0.0.1"`` keeps it local)."""

    def __init__(
        self,
        *,
        textfile: Optional[str] = None,
        port: Optional[int] = None,
        rank: int = 0,
        min_interval: float = 1.0,
        host: str = "",
    ):
        if port is not None and rank != 0:
            raise ValueError(
                f"--metrics_port is rank-0-only (one /metrics endpoint per "
                f"run); refusing to bind on rank {rank} — rank {rank} still "
                "exports via its own --metrics_file when asked"
            )
        self.textfile = textfile
        self.min_interval = min_interval
        self._last_write = float("-inf")
        self._lock = threading.Lock()
        self._body = b"# EOF\n"
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        if textfile:
            d = os.path.dirname(os.path.abspath(textfile))
            os.makedirs(d, exist_ok=True)
        if port is not None:
            srv = ThreadingHTTPServer((host, port), _Handler)
            srv.daemon_threads = True
            # the handler reads ONLY this closure — last rendered bytes
            # under the lock; never the live registry or the model
            srv.exporter_body = self._snapshot  # type: ignore[attr-defined]
            self._server = srv
            self.port = srv.server_address[1]  # resolves port=0 requests
            self._thread = threading.Thread(
                target=srv.serve_forever, name="metrics-exporter", daemon=True
            )
            self._thread.start()

    def _snapshot(self) -> bytes:
        with self._lock:
            return self._body

    def update(
        self,
        values: Dict[str, float],
        labeled: Optional[Dict[str, Dict[str, float]]] = None,
        *,
        histograms: Optional[Dict[str, dict]] = None,
        force: bool = False,
    ) -> bool:
        """Publish a new exposition.  Returns True when the textfile was
        (re)written — inside the throttle window only the in-memory HTTP
        snapshot moves (it is free), matching the heartbeat's step-grain
        discipline.  ``histograms`` adds OpenMetrics histogram families
        (the serving latency distributions).  Never raises on I/O: a
        full disk must not kill the training step that exported."""
        text = render(values, labeled, histograms=histograms)
        with self._lock:
            self._body = text.encode()
        if not self.textfile:
            return False
        now = time.monotonic()
        if not force and now - self._last_write < self.min_interval:
            return False
        self._last_write = now
        tmp = f"{self.textfile}.tmp.{os.getpid()}"
        try:
            # tpu-dist: ignore[TD002] — per-process by construction: the caller derives one textfile path per rank (heartbeat.per_rank_path)
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, self.textfile)
        except OSError:
            counters.inc("export.write_errors")
            return False
        counters.inc("export.writes")
        return True

    def close(self) -> None:
        """Stop the HTTP thread; the textfile is left behind deliberately
        (the last exposition documents how the run ended — a scraper sees
        final totals, not a 404)."""
        if self._server is not None:
            srv, self._server = self._server, None
            srv.shutdown()
            srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def active_labels(
    vals: Dict[str, float], family: str = "alert_active"
) -> list:
    """Label values of ``family``'s nonzero samples in a scraped
    exposition (``{name{key="label"}: value}`` as :func:`parse` returns
    them), sorted — e.g. the firing alert-rule names."""
    prefix = metric_name(family) + "{"
    out = []
    for name, v in vals.items():
        if not name.startswith(prefix) or not v:
            continue
        parts = name[len(prefix):].split('"')
        # parse() admits any `name{...} value` line, quoted or not: a
        # sample without a quoted label is skipped, never a crash
        if len(parts) >= 2:
            out.append(parts[1])
    return sorted(out)


#: The "why was this worker sick" gauge set of a watchdog's report, the
#: JAX package's list: (raw registry name, short label, format).
KEY_GAUGES = (
    ("train.epoch", "epoch", "g"),
    ("train.data_stall_frac", "stall", ".1%"),
    ("train.mfu", "mfu", ".3f"),
    ("goodput.goodput_frac", "goodput", ".1%"),
    ("compile.retraces", "retraces", "g"),
    # the memory layer (obs/memory.py): worst-chip peak HBM and the free
    # headroom fraction — a sick worker that was about to OOM says so
    ("mem.peak_bytes_in_use", "peak_hbm_B", "g"),
    ("mem.headroom_frac", "hbm_free", ".1%"),
    # the serving layer (serve/slo.py): a sick SERVING replica's report
    # must say WHY — was the queue exploding, was availability gone, was
    # the p99 bound blown — not just that the process wedged
    ("serve.queue_depth", "queue", "g"),
    ("serve.availability", "avail", ".1%"),
    ("serve.latency_p99_ms", "p99_ms", ".1f"),
)


def key_gauges(vals: Dict[str, float]) -> Dict[str, str]:
    """The :data:`KEY_GAUGES` subset of a scraped exposition, formatted:
    ``{"epoch": "2", "stall": "41.0%", ...}`` — absent gauges omitted."""
    out: Dict[str, str] = {}
    for raw, label, spec in KEY_GAUGES:
        v = vals.get(metric_name(raw))
        if v is not None:
            out[label] = format(v, spec)
    return out


def scrape(
    *, textfile: Optional[str] = None, port: Optional[int] = None,
    host: str = "127.0.0.1", timeout: float = 2.0,
) -> Optional[Dict[str, float]]:
    """Watchdog-side read of a live exposition: the textfile when given
    (preferred — works across mounts, no socket), else one HTTP GET.
    None when nothing is readable — the caller degrades to its
    heartbeat-only report, never raises."""
    if textfile:
        try:
            with open(textfile) as f:
                return parse(f.read())
        except OSError:
            return None
    if port:
        try:
            with socket.create_connection((host, port), timeout=timeout) as s:
                s.sendall(
                    f"GET /metrics HTTP/1.0\r\nHost: {host}\r\n\r\n".encode()
                )
                chunks = []
                while True:
                    b = s.recv(65536)
                    if not b:
                        break
                    chunks.append(b)
            raw = b"".join(chunks).decode("utf-8", "replace")
            body = raw.split("\r\n\r\n", 1)
            return parse(body[1]) if len(body) == 2 else None
        except OSError:
            return None
    return None
