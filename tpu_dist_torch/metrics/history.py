"""JSONL metrics history: the port's copy of
``tpu_dist/metrics/history.py`` (``MetricsHistory``, ``SCHEMA_VERSION``).

One JSON object per line, appended, written by rank 0 only (or by every
rank to its own file: the trainer's ``--per_host_log``, rank k writing
``<log_file>.h<k>``). Every record carries

* ``ts``: wall clock (epoch seconds);
* ``rel_s``: monotonic seconds since the history's origin (the trainer's
  construction);
* ``schema_version``, and ``run_id`` when the owner passed one (stamped
  once a run, so every line of a run agrees);
* ``kind`` and the caller's fields;
* ``counters``: a snapshot of :mod:`tpu_dist_torch.obs.counters`, when
  it is not empty.

The schema is the JAX package's, so its offline readers
(``python -m tpu_dist.obs summarize``/``tail``/``compare``) read the
port's files as they are. The port's trainer writes the ``train_epoch``,
``eval`` and ``auto_recover`` kinds.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from tpu_dist_torch.comm import mesh
from tpu_dist_torch.obs import counters
from tpu_dist_torch.obs.heartbeat import per_rank_path  # noqa: F401  (re-exported: --per_host_log names its files so)

SCHEMA_VERSION = 15  # the JAX package's (tpu_dist/metrics/history.py:81)


class MetricsHistory:
    def __init__(self, path: Optional[str], run_id: Optional[str] = None,
                 t0: Optional[float] = None, all_processes: bool = False):
        """``path=None`` disables it, and so does any rank but 0 unless
        ``all_processes`` (the caller then gives each rank its own path).
        ``t0`` (a ``time.monotonic()`` reading) is the ``rel_s`` origin."""
        self.path = path if path and (all_processes or mesh.process_index() == 0) else None
        self.run_id = run_id
        self._f = None
        self._t0 = t0 if t0 is not None else time.monotonic()
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            # line-buffered: each record is flushed whole, so a reader
            # following the file sees complete lines only
            # tpu-dist: ignore[TD002] — self.path is None off rank 0 unless the caller opted into per-rank files
            self._f = open(self.path, "a", buffering=1)

    def log(self, kind: str, **fields) -> None:
        if self._f is None:
            return
        rec = {
            "ts": round(time.time(), 3),
            "rel_s": round(time.monotonic() - self._t0, 3),
            "schema_version": SCHEMA_VERSION,
            "kind": kind,
        }
        if self.run_id:
            rec["run_id"] = self.run_id
        rec.update({k: (float(v) if hasattr(v, "item") else v) for k, v in fields.items()})
        if "counters" not in rec:
            snap = counters.snapshot()
            if snap:
                rec["counters"] = snap
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f is not None:
            f, self._f = self._f, None
            f.close()
