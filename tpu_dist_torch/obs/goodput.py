"""The offline goodput ledger: the port's copy of the reading half of
``tpu_dist/obs/goodput.py`` (``BUCKETS``, ``ALL_BUCKETS``,
``resume_direction``, ``run_ledger``), which the history summary folds a
log's ``goodput`` records through. The live ``GoodputLedger`` that
writes them is not ported (ROADMAP Queue A 6, telemetry): a port history
has no ``goodput`` records and its ledger is None, while a JAX history
reads as it does there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: Attributable buckets, in report order. ``unattributed`` is derived
#: (window minus the rest), never written to directly.
BUCKETS: Tuple[str, ...] = (
    "productive", "compile", "ckpt", "data_stall", "eval",
    "preempt", "preempt_for_serve", "recovery",
)
ALL_BUCKETS: Tuple[str, ...] = BUCKETS + ("unattributed",)


def resume_direction(rec: dict) -> Optional[str]:
    """Classify a ``resume`` record's elastic direction — ONE home for
    the ``prev_dp``/``dp`` comparison every consumer renders or charges
    by (this ledger, ``summarize``, ``tail``, ``pod``):

    * ``'grown'`` — the world got BIGGER (scale-up / fleet receipt),
    * ``'resharded'`` — any other elastic resize: a shrink, or a
      same-size restore whose dp-dependent leaves were re-laid,
    * ``None`` — a plain same-world resume (no elastic resize at all).
    """
    prev_dp, dp = rec.get("prev_dp"), rec.get("dp")
    ints = isinstance(prev_dp, int) and isinstance(dp, int)
    if ints and dp > prev_dp:
        return "grown"
    if rec.get("resharded") or (ints and dp != prev_dp):
        return "resharded"
    return None



def _zero_totals() -> Dict[str, float]:
    out = {f"{b}_s": 0.0 for b in ALL_BUCKETS}
    out["elapsed_s"] = 0.0
    return out


def run_ledger(records: List[dict]) -> Optional[dict]:
    """Fold a history's ``goodput`` records — across resumed segments —
    into one run-level ledger.

    Segments are delimited the way ``summarize`` delimits them: a
    ``run_id`` change mid-file is a restart (same logical run, fresh
    process). Within a segment the run-end totals record (``final: true``)
    is authoritative; a segment that died before writing one (preemption,
    crash) is reconstructed by summing its window records. The wall-clock
    gap between a segment's LAST record and the next segment's
    construction instant (its first record's ``ts - rel_s``) is the
    restart loss nobody inside either process could see — it lands in
    ``preempt_s``, except when the new segment opens with an ELASTIC
    ``resume`` record: one flagged resharded, or one whose world size
    changed (``prev_dp != dp`` — a probe-triggered grow or a
    scheduler-initiated donation can re-lay zero leaves when the padded
    lengths happen to agree, and a voluntary resize must never inflate
    ``preempt_s``). That gap is the reshard/resize+relaunch cost of
    keeping the run alive at a new world size and is charged to
    ``recovery_s`` — UNLESS the resume carries a propagated
    ``decision_id`` with ``decision_cause == "serve_breach"`` (schema
    v15: the fleet arbiter preempted this run for a breached serving
    SLO), in which case it is charged to ``preempt_for_serve_s``: the
    pod CHOSE to pay that gap for the SLO, and budgeting it as generic
    elastic recovery would hide the cost of the co-scheduling policy
    The partition invariant is untouched: all three gap
    accumulators land in ``restart_gap_s`` and ``elapsed_s``, so the
    buckets still sum to wall-clock exactly. Returns None when the log
    holds no goodput records (an old-schema log)."""
    totals = _zero_totals()
    n_segments = 0
    saw_goodput = False
    cur_run = object()
    seg_final: Optional[dict] = None
    seg_windows = _zero_totals()
    seg_has_window = False
    last_ts: Optional[float] = None
    restart_s = 0.0
    reshard_gap_s = 0.0
    serve_gap_s = 0.0

    def fold_segment():
        nonlocal seg_final, seg_windows, seg_has_window
        src = None
        if seg_final is not None:
            src = seg_final
        elif seg_has_window:
            src = seg_windows
        if src is not None:
            for b in ALL_BUCKETS:
                totals[f"{b}_s"] += float(src.get(f"{b}_s", 0.0) or 0.0)
            totals["elapsed_s"] += float(src.get("elapsed_s", 0.0) or 0.0)
        seg_final, seg_windows, seg_has_window = None, _zero_totals(), False

    for rec in records:
        rid = rec.get("run_id")
        if n_segments == 0:
            cur_run = rid
            n_segments = 1
        elif rid is not None and rid != cur_run:
            # a NON-None run_id change is a restart (same rule summarize
            # uses for its counter-delta resets); id-less records — old
            # schemas, foreign lines — never split a segment
            fold_segment()
            # restart gap: previous segment's last visible instant to
            # this segment's construction (ts minus its rel_s offset).
            # A segment whose boundary record is a resharded 'resume'
            # came back at a NEW world size — its gap is elastic
            # recovery, not preemption loss
            ts, rel = rec.get("ts"), rec.get("rel_s")
            if (
                last_ts is not None
                and isinstance(ts, (int, float))
                and isinstance(rel, (int, float))
            ):
                gap = max(float(ts) - float(rel) - last_ts, 0.0)
                if (
                    rec.get("kind") == "resume"
                    and resume_direction(rec) is not None
                ):
                    if (
                        rec.get("decision_cause") == "serve_breach"
                        and rec.get("decision_id") is not None
                    ):
                        # the fleet arbiter took the chips for a
                        # breached serving SLO (the relaunch env
                        # propagated its decision_id here) — this gap
                        # is the chosen cost of the co-scheduling
                        # policy, not generic elastic recovery
                        serve_gap_s += gap
                    else:
                        reshard_gap_s += gap
                else:
                    restart_s += gap
            cur_run = rid
            n_segments += 1
        if isinstance(rec.get("ts"), (int, float)):
            last_ts = float(rec["ts"])
        if rec.get("kind") != "goodput":
            continue
        saw_goodput = True
        if rec.get("final"):
            seg_final = rec
        else:
            seg_has_window = True
            for b in ALL_BUCKETS:
                seg_windows[f"{b}_s"] += float(rec.get(f"{b}_s", 0.0) or 0.0)
            seg_windows["elapsed_s"] += float(rec.get("window_s", 0.0) or 0.0)
    fold_segment()
    if not saw_goodput:
        return None
    totals["preempt_s"] = round(totals["preempt_s"] + restart_s, 4)
    totals["preempt_for_serve_s"] = round(
        totals["preempt_for_serve_s"] + serve_gap_s, 4
    )
    totals["recovery_s"] = round(totals["recovery_s"] + reshard_gap_s, 4)
    totals["restart_gap_s"] = round(
        restart_s + reshard_gap_s + serve_gap_s, 4
    )
    totals["elapsed_s"] = round(
        totals["elapsed_s"] + restart_s + reshard_gap_s + serve_gap_s, 4
    )
    for b in ALL_BUCKETS:
        totals[f"{b}_s"] = round(totals[f"{b}_s"], 4)
    totals["n_segments"] = n_segments
    totals["goodput_frac"] = round(
        totals["productive_s"] / totals["elapsed_s"], 4
    ) if totals["elapsed_s"] > 0 else 0.0
    return totals

