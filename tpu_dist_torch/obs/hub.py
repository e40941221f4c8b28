"""The scrape half of the pod telemetry hub: the port's copy of
``tpu_dist/obs/hub.py:40-135`` (``STALE_AFTER_S``, ``RunSource``,
``sample_run``).

Every run publishes its own OpenMetrics exposition (per-rank textfiles
and a rank-0 HTTP endpoint, ``obs/export.py``) and its heartbeat.
:func:`sample_run` is the one scrape primitive over them: one run's
exposition (the textfile first, HTTP when it cannot be read) and its
heartbeat's verdict, as a plain dict. The fleet scheduler's
``read_signals`` reads a run through it and never opens a metrics file
itself.

The rest of the JAX module is not ported yet: the pull aggregator
``TelemetryHub`` (every run's samples relabelled into one federated
exposition, with the pod rollups and counted drops), its HTTP server
``HubServer``, the ``--run`` parser ``parse_source`` and the ``obs hub``
command. They wait with the live goodput ledger, ROADMAP Queue A 6
(telemetry), and so does ``fleet/scheduler.py::signals_from_hub``, which
reads a ``TelemetryHub`` snapshot.

Standard library only: the hub runs on a controller with no device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

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
