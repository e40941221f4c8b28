"""Checked-in baseline: accepted violations the CI gate tolerates.

The gate's contract is *no NEW violations*: findings whose
``(rule, file, line-text)`` key matches a baseline entry are filtered out
before the exit code is computed, so the count can only ratchet down.
Matching ignores line numbers (they drift on every edit) and is multiset —
two identical prints in one file need two entries. Stale entries (baseline
lines the code no longer produces) are reported so the file shrinks as
debt is paid.

Regenerate with ``python -m tpu_dist_torch.analysis --write-baseline``
after a deliberate accept; prefer inline ``# tpu-dist: ignore[TDxxx]`` with
a reason for anything permanent. The port's copy of
``tpu_dist/analysis/baseline.py``; its default file is
:data:`DEFAULT_BASELINE`, which ships with no accepted entry.
"""

from __future__ import annotations

import json
import os
from collections import Counter


#: The baseline the CLI reads when no ``--baseline`` is given.
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "analysis_baseline.json")


def load(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return data.get("accepted", []) if isinstance(data, dict) else data


def _entry_key(entry: dict) -> tuple:
    return (entry.get("rule"), entry.get("path"), (entry.get("snippet") or "").strip())


def apply(violations: list, baseline: list) -> tuple:
    """Returns ``(new_violations, stale_entries)``."""
    budget = Counter(_entry_key(e) for e in baseline)
    new: list = []
    for v in violations:
        key = v.baseline_key()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
        else:
            new.append(v)
    stale = []
    for e in baseline:
        key = _entry_key(e)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            stale.append(e)
    return new, stale


def write(violations: list, path: str) -> None:
    entries = [
        {"rule": v.rule, "path": v.path, "snippet": v.snippet.strip()}
        for v in violations
    ]
    payload = {
        "comment": "accepted analysis findings of tpu_dist_torch; "
        "prefer inline '# tpu-dist: ignore[TDxxx]' suppressions",
        "accepted": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
