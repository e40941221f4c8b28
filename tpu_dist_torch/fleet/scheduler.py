"""The chip-second accounting of ``tpu_dist/fleet/scheduler.py``
(``audit_chip_seconds``). The arbiter itself (``FleetScheduler``, its
policy and sensors) is not ported (ROADMAP Queue A 6, fleet/*). Host
arithmetic only, standard library only.
"""

from __future__ import annotations

from typing import Dict, List


def audit_chip_seconds(
    records: List[dict], tick_s: float = 1.0
) -> dict:
    """The conservation audit over a run's ``tenancy`` snapshots: the
    per-run chip-second buckets ∪ the scheduler's own free/pending
    account must equal the pod's chip-seconds **exactly** — integer
    chip-ticks scaled by ``tick_s``, no float accumulation in the
    identity itself.

    ``records`` is any iterable of history records (non-``tenancy``
    kinds are ignored — pass a whole parsed ``fleet.jsonl``). Returns::

        {"n_ticks", "total_chips", "tick_s",
         "per_run": {run: chip_seconds}, "free_chip_s", "pending_chip_s",
         "accounted_chip_s", "pod_chip_s", "conserved", "violations"}

    ``conserved`` is the exact identity over the whole window;
    ``violations`` lists any single tick where
    ``sum(alloc) + free + pending != total_chips`` (none can occur for
    snapshots one scheduler wrote — the pools are conserved by
    construction — so a violation means the log was edited or mixed from
    two schedulers)."""
    snaps = [r for r in records if r.get("kind") == "tenancy"]
    per_run_ticks: Dict[str, int] = {}
    free_ticks = 0
    pending_ticks = 0
    total_chips = 0
    violations: List[dict] = []
    for r in snaps:
        alloc = r.get("alloc") or {}
        free = int(r.get("free") or 0)
        pending = int(r.get("pending") or 0)
        total_chips = int(r.get("total_chips") or 0)
        for run, a in alloc.items():
            per_run_ticks[run] = per_run_ticks.get(run, 0) + int(a)
        free_ticks += free
        pending_ticks += pending
        if sum(int(a) for a in alloc.values()) + free + pending != total_chips:
            violations.append({
                "tick": r.get("tick"), "alloc": dict(alloc),
                "free": free, "pending": pending,
                "total_chips": total_chips,
            })
    n_ticks = len(snaps)
    accounted_ticks = sum(per_run_ticks.values()) + free_ticks + pending_ticks
    pod_ticks = total_chips * n_ticks
    return {
        "n_ticks": n_ticks,
        "total_chips": total_chips,
        "tick_s": tick_s,
        "per_run": {
            run: t * tick_s for run, t in sorted(per_run_ticks.items())
        },
        "free_chip_s": free_ticks * tick_s,
        "pending_chip_s": pending_ticks * tick_s,
        "accounted_chip_s": accounted_ticks * tick_s,
        "pod_chip_s": pod_ticks * tick_s,
        "conserved": accounted_ticks == pod_ticks and not violations,
        "violations": violations,
    }
