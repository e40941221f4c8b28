"""The pod telemetry hub, one federated ``/metrics`` for N runs: the
port's copy of ``tpu_dist/obs/hub.py``.

Every run publishes its own OpenMetrics exposition (per-rank textfiles
and a rank-0 HTTP endpoint, ``obs/export.py``) and its heartbeat. The hub
is the controller's one place to read them:

* :func:`sample_run`, the one scrape primitive: one run's exposition
  (the textfile first, HTTP when it cannot be read) and its heartbeat's
  verdict, as a plain dict. The fleet scheduler's ``read_signals`` and
  ``signals_from_hub`` read runs through it and never open a metrics
  file themselves.
* :class:`TelemetryHub`, the pull aggregator: it scrapes every
  :class:`RunSource` and counts each degraded scrape (a textfile torn
  mid-write serves the last good parse and counts ``torn``; a stale or
  absent heartbeat marks the run dead with its age, and the run stays on
  the page; a run that has published nothing counts ``absent``), then
  renders one exposition: every sample relabelled ``{run="<name>"}``, the
  hub's own health gauges, and the pod rollups (the cards from the fleet
  scheduler's exposition, the goodput of each class of run, the worst
  stall, the breach count, the last fleet decision). A gauge a run does
  not publish (a CPU run has no ``train.mfu``: no chip peak to divide by)
  is left out of the rollups, never read as 0.
* :class:`HubServer`, the HTTP half, and :func:`parse_source`, the
  ``--run`` grammar of ``python -m tpu_dist_torch.obs hub``.

Standard library only: the hub runs on a controller with no device.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from tpu_dist_torch.obs import export as export_lib
from tpu_dist_torch.obs import heartbeat as heartbeat_lib

#: A heartbeat older than this reads as a dead or wedged run (the fleet
#: scheduler's threshold).
STALE_AFTER_S = 60.0

#: The run classes the rollups group by (``RunSpec.kind``).
RUN_KINDS = ("train", "serve")


@dataclasses.dataclass(frozen=True)
class RunSource:
    """One run to scrape: its exposition (a textfile, or the rank-0 HTTP
    port when the file cannot be read), its heartbeat file, and its class
    (``kind``)."""

    run: str
    metrics_file: Optional[str] = None
    port: Optional[int] = None
    heartbeat_file: Optional[str] = None
    kind: str = "train"

    def __post_init__(self):
        if not self.run:
            raise ValueError("a RunSource needs a run name")
        if self.metrics_file is None and self.port is None:
            raise ValueError(f"{self.run}: need a metrics_file or a port")
        if self.kind not in RUN_KINDS:
            raise ValueError(f"{self.run}: kind {self.kind!r} not in {RUN_KINDS}")


def sample_run(
    run: str,
    *,
    metrics_file: Optional[str] = None,
    port: Optional[int] = None,
    heartbeat_file: Optional[str] = None,
    now: Optional[float] = None,
    stale_after_s: float = STALE_AFTER_S,
) -> dict:
    """One run's latest exposition and its heartbeat's verdict. File and
    socket reads only, never raises: an absent or unreadable exposition
    gives empty ``values``. Returns::

        {"run", "values": {name_or_name{labels}: float},
         "scraped": bool, "source": "textfile"|"http"|None,
         "alive": True|False|None, "heartbeat_age_s": float|None}

    ``alive`` is None without a heartbeat source (liveness unknown), and
    False for a beat that is absent, stale, or has no usable timestamp.
    """
    values: Dict[str, float] = {}
    source: Optional[str] = None
    if metrics_file is not None:
        got = export_lib.scrape(textfile=metrics_file)
        if got is not None:
            values, source = got, "textfile"
    if source is None and port is not None:
        got = export_lib.scrape(port=port)
        if got is not None:
            values, source = got, "http"
    age: Optional[float] = None
    alive: Optional[bool] = None
    if heartbeat_file is not None:
        rec = heartbeat_lib.read(heartbeat_file)
        if rec is None:
            alive = False  # a run that should beat and does not
        else:
            ts = rec.get("ts")
            if isinstance(ts, (int, float)) and not isinstance(ts, bool):
                age = (time.time() if now is None else now) - float(ts)
                alive = age <= stale_after_s
            else:
                alive = False  # a beat without a usable timestamp fails closed
    return {
        "run": run,
        "values": values,
        "scraped": source is not None,
        "source": source,
        "alive": alive,
        "heartbeat_age_s": round(age, 1) if age is not None else None,
    }


def _gauge(values: Dict[str, float], raw: str) -> Optional[float]:
    return values.get(export_lib.metric_name(raw))


class TelemetryHub:
    """Pull-aggregate N :class:`RunSource` expositions into one.

    ``fleet_exposition`` (optional) is the path the fleet scheduler's
    ``FleetScheduler.write_exposition`` publishes: the capacity ledger the
    card rollups come from (total, free and pending cards, the decision
    and preemption counts, the last ``decision_id``). Without it those
    rollups are absent.

    Drops are counted over every :meth:`collect` call (the hub's
    ``hub.drops_total{reason=...}`` family) and in each snapshot
    (``snapshot["drops"]``): a torn exposition, a dead run, an absent one.
    """

    def __init__(
        self,
        sources: List[RunSource],
        *,
        fleet_exposition: Optional[str] = None,
        stale_after_s: float = STALE_AFTER_S,
    ):
        if not sources:
            raise ValueError("a hub needs at least one RunSource")
        names = [s.run for s in sources]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate run names: {names}")
        self.sources = list(sources)
        self.fleet_exposition = fleet_exposition
        self.stale_after_s = stale_after_s
        self.scrapes = 0
        self.drops_total = {"torn": 0, "dead": 0, "absent": 0}
        # the last good parse of each run: a textfile torn mid-write serves
        # the previous parse, not a hole, and is counted doing it
        self._last_good: Dict[str, Dict[str, float]] = {}

    # -- scraping ------------------------------------------------------------

    def _scrape_one(self, src: RunSource, now: Optional[float]) -> dict:
        """One run's view: :func:`sample_run`, with a textfile that does not
        end in ``# EOF`` read as torn (caught mid-write by a publisher that
        does not rename; the last good parse is served) and the dead and
        absent verdicts."""
        torn = False
        if src.metrics_file is not None:
            try:
                with open(src.metrics_file) as f:
                    text = f.read()
            except OSError:
                text = None
            if text is not None and not text.rstrip().endswith("# EOF"):
                torn = True
        sample = sample_run(
            src.run,
            metrics_file=src.metrics_file,
            port=src.port,
            heartbeat_file=src.heartbeat_file,
            now=now,
            stale_after_s=self.stale_after_s,
        )
        sample["kind"] = src.kind
        if torn and sample["source"] == "textfile":
            sample["values"] = dict(self._last_good.get(src.run, {}))
            sample["torn"] = True
        else:
            sample["torn"] = False
            if sample["values"]:
                self._last_good[src.run] = dict(sample["values"])
        sample["dead"] = sample["alive"] is False
        sample["absent"] = not sample["values"] and not sample["torn"]
        return sample

    def collect(self, now: Optional[float] = None) -> dict:
        """One aggregation pass: every source scraped, the drops counted,
        the rollups computed. Returns the snapshot :meth:`federated`
        renders (``runs`` keeps every registered run: a dead one is marked
        dead with its last-seen age, never removed)."""
        self.scrapes += 1
        runs: Dict[str, dict] = {}
        drops = {"torn": 0, "dead": 0, "absent": 0}
        for src in self.sources:
            sample = self._scrape_one(src, now)
            runs[src.run] = sample
            for reason in drops:
                if sample.get(reason):
                    drops[reason] += 1
                    self.drops_total[reason] += 1
        fleet: Dict[str, float] = {}
        if self.fleet_exposition:
            fleet = export_lib.scrape(textfile=self.fleet_exposition) or {}
        return {
            "runs": runs,
            "drops": drops,
            "drops_total": dict(self.drops_total),
            "fleet": fleet,
            "rollup": self._rollup(runs, fleet),
            "scrapes": self.scrapes,
        }

    def _rollup(self, runs: Dict[str, dict], fleet: Dict[str, float]) -> dict:
        """The pod gauges: the cards from the fleet scheduler's exposition,
        the mean goodput of each class of run, the worst stall, and how
        many runs fire an ``slo_*`` alert. A run without a gauge adds
        nothing to its rollup."""
        out: dict = {
            "runs_aggregated": sum(1 for s in runs.values() if s["values"]),
            "runs_dead": sum(1 for s in runs.values() if s["dead"]),
        }
        for raw, name in (
            ("fleet.total_chips", "total_chips"),
            ("fleet.free_chips", "free_chips"),
            ("fleet.pending_chips", "pending_chips"),
            ("fleet.decisions", "decisions"),
            ("fleet.preemptions", "preemptions"),
            ("fleet.last_decision_id", "last_decision_id"),
        ):
            v = _gauge(fleet, raw)
            if v is not None:
                out[name] = v
        goodput: Dict[str, List[float]] = {}
        worst_stall: Optional[Tuple[float, str]] = None
        breaches = 0
        for name, s in runs.items():
            vals = s["values"]
            g = _gauge(vals, "goodput.goodput_frac")
            if g is not None:
                goodput.setdefault(s["kind"], []).append(g)
            stall = _gauge(vals, "train.data_stall_frac")
            if stall is not None and (worst_stall is None or stall > worst_stall[0]):
                worst_stall = (stall, name)
            if any(a.startswith("slo_") for a in export_lib.active_labels(vals)):
                breaches += 1
        out["goodput_by_kind"] = {
            kind: round(sum(v) / len(v), 4) for kind, v in sorted(goodput.items())
        }
        if worst_stall is not None:
            out["worst_stall_frac"] = worst_stall[0]
            out["worst_stall_run"] = worst_stall[1]
        out["breach_count"] = breaches
        return out

    # -- federation ----------------------------------------------------------

    @staticmethod
    def _labeled(name: str, run: str) -> str:
        """Add the ``run`` label to a scraped sample's name:
        ``tpu_dist_x`` -> ``tpu_dist_x{run="r"}``, and a labelled
        ``tpu_dist_alert_active{rule="y"}`` keeps its label:
        ``tpu_dist_alert_active{rule="y",run="r"}``."""
        safe = run.replace("\\", "\\\\").replace('"', '\\"')
        if name.endswith("}") and "{" in name:
            return f'{name[:-1]},run="{safe}"}}'
        return f'{name}{{run="{safe}"}}'

    def federated(self, snapshot: Optional[dict] = None) -> str:
        """Render one snapshot as the pod's exposition: every run's samples
        relabelled ``{run=...}``, the hub's health and drop gauges, and the
        ``pod.*`` rollups. Ends with ``# EOF``."""
        snap = snapshot if snapshot is not None else self.collect()
        lines: List[str] = []
        rollup = snap["rollup"]
        pod_values = {
            "pod.runs_aggregated": rollup.get("runs_aggregated", 0),
            "pod.runs_dead": rollup.get("runs_dead", 0),
            "pod.breach_count": rollup.get("breach_count", 0),
            "hub.scrapes_total": snap.get("scrapes", self.scrapes),
        }
        for name in ("total_chips", "free_chips", "pending_chips", "decisions",
                     "preemptions", "last_decision_id", "worst_stall_frac"):
            if rollup.get(name) is not None:
                pod_values[f"pod.{name}"] = rollup[name]
        for raw in sorted(pod_values):
            name = export_lib.metric_name(raw)
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {export_lib._fmt_value(pod_values[raw])}")
        drops_name = export_lib.metric_name("hub.drops_total")
        lines.append(f"# TYPE {drops_name} gauge")
        for reason in sorted(snap["drops_total"]):
            lines.append(f'{drops_name}{{reason="{reason}"}} '
                         f'{export_lib._fmt_value(snap["drops_total"][reason])}')
        gpk = rollup.get("goodput_by_kind") or {}
        if gpk:
            name = export_lib.metric_name("pod.goodput_frac")
            lines.append(f"# TYPE {name} gauge")
            for kind in sorted(gpk):
                lines.append(f'{name}{{kind="{kind}"}} {export_lib._fmt_value(gpk[kind])}')
        up_name = export_lib.metric_name("hub.run_up")
        age_name = export_lib.metric_name("hub.run_heartbeat_age_s")
        lines.append(f"# TYPE {up_name} gauge")
        for run in sorted(snap["runs"]):
            up = 0 if snap["runs"][run]["dead"] else 1
            lines.append(f"{self._labeled(up_name, run)} {up}")
        if any(s["heartbeat_age_s"] is not None for s in snap["runs"].values()):
            lines.append(f"# TYPE {age_name} gauge")
        for run in sorted(snap["runs"]):
            s = snap["runs"][run]
            if s["heartbeat_age_s"] is not None:
                lines.append(f"{self._labeled(age_name, run)} "
                             f"{export_lib._fmt_value(s['heartbeat_age_s'])}")
        for run in sorted(snap["runs"]):
            for name in sorted(snap["runs"][run]["values"]):
                v = snap["runs"][run]["values"][name]
                lines.append(f"{self._labeled(name, run)} {export_lib._fmt_value(v)}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def write(self, path: str, snapshot: Optional[dict] = None) -> None:
        """Publish the federated exposition atomically (a temporary file and
        ``os.replace``: a scraper never reads a torn page)."""
        text = self.federated(snapshot)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)


class HubServer:
    """The hub's HTTP half: ``GET /metrics`` serves the last published page
    (bytes under a lock; the handler thread never scrapes, so a slow source
    never stalls a scrape of the hub)."""

    def __init__(self, port: int, host: str = ""):
        from http.server import ThreadingHTTPServer  # noqa: PLC0415

        self._lock = threading.Lock()
        self._body = b"# EOF\n"
        srv = ThreadingHTTPServer((host, port), export_lib._Handler)
        srv.daemon_threads = True
        srv.exporter_body = self._snapshot  # type: ignore[attr-defined]
        self._server: Optional[ThreadingHTTPServer] = srv
        self.port = srv.server_address[1]  # the port a request for 0 got
        self._thread: Optional[threading.Thread] = threading.Thread(
            target=srv.serve_forever, name="telemetry-hub", daemon=True)
        self._thread.start()

    def _snapshot(self) -> bytes:
        with self._lock:
            return self._body

    def publish(self, text: str) -> None:
        with self._lock:
            self._body = text.encode()

    def close(self) -> None:
        if self._server is not None:
            srv, self._server = self._server, None
            srv.shutdown()
            srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "HubServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def parse_source(spec: str) -> RunSource:
    """One ``--run``: ``name=metrics_path`` with optional ``,hb=<heartbeat>``,
    ``,port=<p>`` and ``,kind=<train|serve>`` parts, e.g.
    ``svc=/pod/svc/metrics.prom,hb=/pod/svc/hb.json,kind=serve``. A bare
    ``name=port:9100`` is an HTTP-only source."""
    if "=" not in spec:
        raise ValueError(f"--run {spec!r}: want name=metrics_path[,...]")
    run, rest = spec.split("=", 1)
    parts = rest.split(",")
    kw: dict = {"run": run}
    head = parts[0]
    if head.startswith("port:"):
        kw["port"] = int(head[len("port:"):])
    elif head:
        kw["metrics_file"] = head
    for part in parts[1:]:
        if "=" not in part:
            raise ValueError(f"--run {spec!r}: bad part {part!r}")
        k, v = part.split("=", 1)
        if k == "hb":
            kw["heartbeat_file"] = v
        elif k == "port":
            kw["port"] = int(v)
        elif k == "kind":
            kw["kind"] = v
        else:
            raise ValueError(f"--run {spec!r}: unknown key {k!r}")
    return RunSource(**kw)
