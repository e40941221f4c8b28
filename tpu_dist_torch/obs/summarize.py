"""Reading a run's JSONL history: the port's copy of the loader of
``tpu_dist/obs/summarize.py`` (``load_records``, ``SUPPORTED_SCHEMA``,
``KNOWN_KINDS``). The summary, the trace export and the comparison of
that module are not ported; ``python -m tpu_dist.obs summarize`` reads
the port's files as they are."""

from __future__ import annotations

import json
from typing import List, Tuple

#: Newest history schema the JAX package's reader fully understands
#: (``metrics/history.py::SCHEMA_VERSION``); every schema bump is additive.
SUPPORTED_SCHEMA = 15

#: Record kinds the JAX package's summary folds in; others are skipped
#: with a count there.
KNOWN_KINDS = frozenset((
    "train_epoch", "eval", "straggler", "anomaly", "device_stats",
    "auto_recover", "spans", "goodput", "profile", "alert",
    "profile_analysis", "resume", "fleet", "postmortem", "serve",
    "memory", "plan", "tune", "tenancy",
))


def load_records(path: str) -> Tuple[List[dict], int]:
    """Parse the JSONL; returns ``(records, n_bad_lines)``. A torn line (a
    writer killed mid-line) or a line that is not an object is counted,
    not fatal."""
    records: List[dict] = []
    bad = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                bad += 1
    return records, bad
