"""The goodput ledger: where a run's wall clock went. The port's copy of
``tpu_dist/obs/goodput.py``, both halves.

Of every second a run held its devices (start-up, the first step's
library loads, checkpoint I/O, input stalls, evals, preemptions and the
relaunches after them), which were productive training? The ledger
partitions the run's wall clock, from the Trainer's construction to the
end of ``fit``, resumed segments included, into buckets that sum to the
elapsed time by construction (field ``<name>_s`` in every record):
``productive`` (the step loop stepping), ``compile`` (what the trainer
defines as its start-up cost of the step: the port compiles no XLA
program, see ``train/trainer.py``), ``ckpt`` (saves, restores, drains),
``data_stall`` (waiting on the loader), ``eval``, ``preempt`` (the
SIGTERM-to-exit tail, and offline the gap to the next segment),
``preempt_for_serve`` (a relaunch gap the fleet arbiter chose for a
breached serving SLO), ``recovery`` (auto-recovery, an elastic reshard,
and offline the gap of any other resize) and ``unattributed`` (the
remainder, never hidden).

* **Live** (:class:`GoodputLedger`): the trainer attributes seconds as
  they happen and logs one ``goodput`` history record an epoch, a
  ``tail`` record and a ``final`` totals record at the end of ``fit``,
  and the rank-0 :func:`ledger_line`. The windows chain, so the records
  partition the run. The clock is injectable (``t0``, ``now``).
* **Offline** (:func:`run_ledger`): fold a history, several resumed
  segments included, back into one run-level ledger, which the history
  summary and ``obs compare --goodput`` read.

Standard library only: the offline half runs wherever a log can be
copied to, and the live half is host arithmetic.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

#: Attributable buckets, in report order. ``unattributed`` is derived
#: (window minus the rest), never written to directly.
BUCKETS: Tuple[str, ...] = (
    "productive", "compile", "ckpt", "data_stall", "eval",
    "preempt", "preempt_for_serve", "recovery",
)
ALL_BUCKETS: Tuple[str, ...] = BUCKETS + ("unattributed",)


class GoodputLedger:
    """Live wall-clock bookkeeping for one process's run.

    The clock origin ``t0`` is the Trainer's construction instant (a
    ``time.monotonic()`` reading). :meth:`window_record` closes the current
    window (everything since the previous record), derives
    ``unattributed`` as the unexplained remainder and folds the window into
    the run totals, so the records partition ``[t0, now]`` exactly and the
    buckets sum to the elapsed wall clock by construction.
    """

    def __init__(self, t0: Optional[float] = None):
        self.t0 = t0 if t0 is not None else time.monotonic()
        self._mark = self.t0
        self._window: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._totals: Dict[str, float] = {b: 0.0 for b in ALL_BUCKETS}

    def add(self, bucket: str, seconds: float) -> None:
        """Attribute ``seconds`` of the current window to ``bucket``; a
        negative reading (clock trouble) counts as zero rather than break
        the partition."""
        if bucket not in self._window:
            raise ValueError(f"unknown goodput bucket {bucket!r}; have {BUCKETS}")
        if seconds > 0:
            self._window[bucket] += float(seconds)

    @contextlib.contextmanager
    def timed(self, bucket: str):
        """Attribute a region's wall time to ``bucket``, also when it raises
        (a failed checkpoint write still spent the seconds)."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add(bucket, time.monotonic() - t0)

    def window_value(self, bucket: str) -> float:
        """Seconds attributed to ``bucket`` in the open window (the trainer
        takes an epoch's mid-epoch checkpoint time out of its productive
        remainder)."""
        return self._window[bucket]

    def window_record(self, now: Optional[float] = None) -> Dict[str, float]:
        """Close the current window: its seconds a bucket, ``window_s`` and
        the derived ``unattributed_s``; folds them into the run totals and
        opens the next window at ``now``."""
        now = time.monotonic() if now is None else now
        window_s = max(now - self._mark, 0.0)
        attributed = sum(self._window.values())
        # regions counted twice would push the remainder below zero: clamp
        # it, and let the buckets overshoot the window where it shows
        unattributed = max(window_s - attributed, 0.0)
        rec = {f"{b}_s": round(self._window[b], 4) for b in BUCKETS}
        rec["unattributed_s"] = round(unattributed, 4)
        rec["window_s"] = round(window_s, 4)
        for b in BUCKETS:
            self._totals[b] += self._window[b]
            self._window[b] = 0.0
        self._totals["unattributed"] += unattributed
        self._mark = now
        return rec

    def run_totals(self, now: Optional[float] = None) -> Dict[str, float]:
        """The whole run's ledger over every closed window: the bucket
        totals, ``elapsed_s`` and ``goodput_frac``. Call
        :meth:`window_record` first to fold the open tail in. ``now`` is
        accepted for the JAX signature and does not move the totals."""
        elapsed = max(self._mark - self.t0, 0.0)
        out = {f"{b}_s": round(self._totals[b], 4) for b in ALL_BUCKETS}
        out["elapsed_s"] = round(elapsed, 4)
        out["goodput_frac"] = round(
            self._totals["productive"] / elapsed, 4
        ) if elapsed > 0 else 0.0
        return out


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


def fleet_move_phrase(rec: dict) -> str:
    """The "who -> whom" phrase of a ``fleet`` decision record: a grant (no
    donor: cards from the free pool), a donation (no recipient: cards bank
    as pending for ``for_run``), or the paired form other tools may
    write; with the SLO-preemption mark and the decision's id."""
    donor, recipient = rec.get("donor"), rec.get("recipient")
    if donor and recipient:
        phrase = f"{donor} -> {recipient}"
    elif recipient:
        phrase = f"free pool -> {recipient}"
    elif donor:
        phrase = f"{donor} -> pending pool"
        if rec.get("for_run"):
            phrase += f" (toward {rec['for_run']})"
    else:
        phrase = "?"
    phrase += f" ({rec.get('chips')} chip(s))"
    if rec.get("preempt"):
        phrase += " [SLO preemption]"
    if rec.get("decision_id") is not None:
        phrase += f" [decision #{rec['decision_id']}]"
    return phrase


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
    elastic recovery would hide the cost of the co-scheduling policy.
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



def ledger_line(totals: dict) -> str:
    """The one-line rank-0 rendering of a run ledger (live or offline)."""
    parts = []
    for b in ALL_BUCKETS:
        v = totals.get(f"{b}_s", 0.0) or 0.0
        if v:
            parts.append(f"{b} {v:.1f}s")
    frac = totals.get("goodput_frac")
    return (
        f"goodput: {frac:.1%} of {totals.get('elapsed_s', 0.0):.1f}s "
        "wall-clock productive"
        + (f" ({', '.join(parts)})" if parts else "")
        + (
            f" across {totals['n_segments']} segment(s)"
            if totals.get("n_segments", 1) > 1 else ""
        )
    )
