"""``obs tail``: follow a live run from another terminal; the port's copy
of ``tpu_dist/obs/tail.py``.

``summarize`` reads a finished log; this module watches a growing one: it
tails the ``--log_file`` JSONL (and optionally the heartbeat file) as
``tail -f`` would, but schema-aware: a rolling per-epoch table of
throughput, step p50, stall, MFU and goodput fraction, the latest alert,
anomaly, straggler, profile, resume, fleet, serving, memory and postmortem
lines, and a heartbeat liveness row with its age. A poll can land
mid-line, so the follower consumes only complete lines and leaves a torn
tail for the next poll. The frames and the exit codes are the JAX
package's on the same files.

Stdlib and file reads only: it runs on any machine the log is visible
from and never touches the training process. The CLI is
``python -m tpu_dist_torch.obs tail run.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, TextIO

from tpu_dist_torch.obs import heartbeat as heartbeat_lib
from tpu_dist_torch.obs.goodput import fleet_move_phrase, resume_direction

#: epochs shown in the rolling table (older rows scroll off — the full
#: history is what ``summarize`` is for)
DEFAULT_ROWS = 10
#: event lines (alert/anomaly/straggler/profile) kept on screen
DEFAULT_EVENTS = 8
#: heartbeat age above which the liveness row flags STALE (matches the
#: built-in ``heartbeat_stale`` alert rule's threshold)
STALE_AFTER_S = 60.0


class LogFollower:
    """Incremental JSONL reader: each :meth:`poll` returns the records
    appended since the last one, consuming only complete lines.  A
    shrunken file (rotation / a fresh run reusing the path) resets the
    cursor to the start rather than silently reading garbage."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self.bad_lines = 0

    def poll(self) -> List[dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self._pos:  # truncated/rotated: start over
            self._pos = 0
        if size == self._pos:
            return []
        with open(self.path, "rb") as f:
            f.seek(self._pos)
            chunk = f.read(size - self._pos)
        # consume complete lines only; a torn tail stays on disk for the
        # next poll (the writer will finish it — or never, in which case
        # it is exactly the torn trailing line summarize tolerates)
        end = chunk.rfind(b"\n")
        if end < 0:
            return []
        self._pos += end + 1
        out: List[dict] = []
        for line in chunk[: end + 1].splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                self.bad_lines += 1
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out


class TailState:
    """Folds a stream of history records into the rolling dashboard
    state; :meth:`render` draws it.  Deterministic given the records and
    the clock inputs — the golden test drives it directly."""

    def __init__(self, rows: int = DEFAULT_ROWS, events: int = DEFAULT_EVENTS):
        self.rows = rows
        self.max_events = events
        self.run_id: Optional[str] = None
        self.schema: Optional[int] = None
        self.n_records = 0
        self.epochs: Dict[int, dict] = {}
        self.events: List[str] = []
        self.alerts_fired = 0
        self.finished = False  # run-end goodput totals record seen
        self.crashed = False   # postmortem crash bundle seen (schema v9)
        self.bundle: Optional[str] = None  # the bundle's path, when known

    def add(self, records: List[dict]) -> None:
        for rec in records:
            self.n_records += 1
            rid = rec.get("run_id")
            if rid is not None and rid != self.run_id:
                if self.run_id is not None:
                    self._event(f"— resumed: new segment {rid} —")
                    self.finished = False
                self.run_id = rid
            sv = rec.get("schema_version")
            self.schema = sv if isinstance(sv, int) else self.schema
            kind = rec.get("kind")
            ep = rec.get("epoch")
            if kind == "train_epoch" and isinstance(ep, int):
                row = self.epochs.setdefault(ep, {})
                row.update({
                    k: rec.get(k)
                    for k in ("images_per_sec", "step_time_p50",
                              "data_stall_frac", "mfu", "loss")
                })
            elif kind == "eval" and isinstance(ep, int):
                self.epochs.setdefault(ep, {})["val_top1"] = rec.get("top1")
            elif kind == "goodput" and rec.get("final"):
                self.finished = True
                gp = rec.get("goodput_frac")
                self._event(
                    f"run ended: goodput {gp:.1%} of "
                    f"{rec.get('elapsed_s', 0):.1f}s wall-clock"
                    if isinstance(gp, (int, float))
                    else "run ended"
                )
            elif kind == "goodput" and isinstance(ep, int) and not rec.get("tail"):
                w = rec.get("window_s")
                p = rec.get("productive_s")
                if isinstance(w, (int, float)) and w > 0 and isinstance(p, (int, float)):
                    self.epochs.setdefault(ep, {})["goodput_frac"] = p / w
            elif kind == "alert":
                self.alerts_fired += 1
                self._event(
                    f"ALERT {rec.get('rule')}: {rec.get('metric')} "
                    f"{rec.get('value')} {rec.get('op')} {rec.get('threshold')} "
                    f"(sustained {rec.get('sustained')} window(s), epoch {ep}"
                    + (f" step {rec.get('step')}" if rec.get("step") is not None else "")
                    + ")"
                )
            elif kind == "anomaly":
                self._event(
                    f"anomaly {rec.get('anomaly')} at epoch {ep} step "
                    f"{rec.get('step')}: value {rec.get('value')}"
                )
            elif kind == "straggler":
                self._event(
                    f"straggler: process {rec.get('worst_rank')} at "
                    f"{rec.get('skew')}x median (epoch {ep})"
                )
            elif kind == "profile":
                evt = rec.get("event")
                if evt == "start":
                    self._event(
                        f"profile capture started ({rec.get('reason')}) "
                        f"at epoch {ep}"
                    )
                elif evt == "stop":
                    self._event(
                        f"profile captured {rec.get('steps')} step(s) "
                        f"({rec.get('reason')})"
                    )
            elif kind == "profile_analysis":
                # one-line device-time attribution per closed capture
                # (obs/xprof.py auto-analysis, schema v6)
                if rec.get("error"):
                    self._event(
                        f"capture analysis FAILED ({rec.get('reason')}): "
                        f"{rec.get('error')}"
                    )
                else:
                    busy = rec.get("device_busy_s")
                    cf = rec.get("collective_frac")
                    ov = rec.get("overlap_frac")
                    fmt = lambda v, s: (  # noqa: E731
                        format(v, s) if isinstance(v, (int, float)) else "-"
                    )
                    self._event(
                        f"capture analysis ({rec.get('reason')}): device "
                        f"busy {fmt(busy, '.3f')}s, collectives "
                        f"{fmt(cf, '.0%')}, overlap {fmt(ov, '.0%')}, "
                        f"infeed stall "
                        f"{fmt(rec.get('infeed_stall_s'), '.3f')}s"
                    )
            elif kind == "auto_recover":
                self._event(
                    f"auto-recover at epoch {ep} (lr_scale "
                    f"{rec.get('lr_scale')})"
                )
            elif kind == "resume":
                # segment boundary with world-size context (schema v7):
                # the host set is not fixed — say which world this
                # segment runs at and which DIRECTION the resize went
                # (GROWN = scale-up/fleet receipt, RESHARDED = shrink;
                # one shared classifier: goodput.resume_direction)
                direction = resume_direction(rec)
                self._event(
                    f"resumed epoch {ep} on {rec.get('world')} "
                    f"process(es), dp={rec.get('dp')}"
                    + (
                        f" — {'GROWN' if direction == 'grown' else 'RESHARDED'}"
                        f" from dp={rec.get('prev_dp')} (elastic)"
                        if direction else ""
                    )
                    + (
                        f", restart #{rec.get('restarts')}"
                        if rec.get("restarts") else ""
                    )
                    + (
                        # causal tracing (schema v15): a resume actuating
                        # a fleet decision names it — live view shows the
                        # same chain the pod report renders offline
                        f" [decision #{rec.get('decision_id')}]"
                        if rec.get("decision_id") is not None else ""
                    )
                )
            elif kind == "fleet":
                # a scheduler decision (schema v8): chips moved between
                # runs sharing this pod — say who paid and who gained
                self._event(
                    "fleet: " + fleet_move_phrase(rec)
                    + (
                        f": {rec.get('reason')}"
                        if rec.get("reason") else ""
                    )
                )
            elif kind == "tenancy":
                # a per-tick chip-accounting snapshot (schema v14):
                # silent while the books balance — every tick would be
                # noise — but a conservation violation is front-page
                alloc = rec.get("alloc") or {}
                accounted = (
                    sum(int(a) for a in alloc.values())
                    + int(rec.get("free") or 0)
                    + int(rec.get("pending") or 0)
                )
                total = int(rec.get("total_chips") or 0)
                if accounted != total:
                    self._event(
                        f"tenancy VIOLATION: tick {rec.get('tick')} "
                        f"accounts {accounted} of {total} chip(s) "
                        f"(alloc {alloc}, free {rec.get('free')}, "
                        f"pending {rec.get('pending')})"
                    )
            elif kind == "serve":
                # a serving SLO window (schema v10) or a mid-serve event
                # (retrace) — one line each, the serving analogue of the
                # epoch row
                if rec.get("event") == "retrace":
                    self._event(
                        f"serve RETRACE: bucket-{rec.get('bucket')} batch "
                        f"({rec.get('n_real')} real) recompiled mid-serve"
                    )
                else:
                    fmt = lambda v, s: (  # noqa: E731
                        format(v, s) if isinstance(v, (int, float)) else "-"
                    )
                    self._event(
                        f"serve: {fmt(rec.get('requests_per_s'), '.1f')} "
                        f"req/s, p50 {fmt(rec.get('latency_p50_ms'), '.2f')} "
                        f"ms, p99 {fmt(rec.get('latency_p99_ms'), '.2f')} ms, "
                        f"avail {fmt(rec.get('availability'), '.3f')}, "
                        f"occupancy {fmt(rec.get('batch_occupancy'), '.2f')}, "
                        f"queue≤{fmt(rec.get('queue_depth_max'), 'g')}"
                        + (
                            f" — {rec['retraces']:g} RETRACE(S)"
                            if rec.get("retraces") else ""
                        )
                    )
            elif kind == "memory":
                # an HBM-ledger snapshot (schema v11) or an OOM event —
                # through the shared obs/memory.py formatters, so tail,
                # summarize, and the pod report render identically
                from tpu_dist_torch.obs import memory as memory_lib

                if rec.get("event") == "oom":
                    oom = rec.get("oom")
                    self._event(
                        memory_lib.oom_summary_line(oom)
                        if isinstance(oom, dict)
                        else "OOM: RESOURCE_EXHAUSTED (unparsed)"
                    )
                else:
                    self._event(memory_lib.summary_line(rec))
            elif kind == "postmortem":
                # a crash bundle landed (schema v9, the watchdog's
                # auto-invoke): the run did NOT end cleanly — render the
                # per-rank fatal/wedge findings and stop following (no
                # goodput-final record is coming from a dead writer)
                self.crashed = True
                self.finished = True
                self.bundle = rec.get("bundle") or self.bundle
                self._event(
                    f"POSTMORTEM: crash bundle over {rec.get('n_ranks')} "
                    "rank(s)"
                    + (f" — {rec['bundle']}" if rec.get("bundle") else "")
                )
                from tpu_dist_torch.obs.postmortem import sorted_ranks

                verdicts = rec.get("verdicts") or {}
                stuck = rec.get("stuck_frames") or {}
                fatal = rec.get("fatal") or {}
                oom = rec.get("oom") or {}
                for rank in sorted_ranks(verdicts):
                    if rank in oom:
                        self._event(f"rank {rank}: {oom[rank]}")
                    elif rank in fatal:
                        self._event(
                            f"fatal on rank {rank}: {fatal[rank]}"
                        )
                    elif rank in stuck:
                        self._event(
                            f"rank {rank} wedged — stuck in {stuck[rank]}"
                        )
                    elif verdicts[rank] not in ("clean", "preempted"):
                        self._event(
                            f"rank {rank}: {verdicts[rank]}"
                        )

    def _event(self, line: str) -> None:
        self.events.append(line)
        del self.events[: -self.max_events]

    def render(
        self,
        heartbeat: Optional[dict] = None,
        *,
        now_wall: Optional[float] = None,
        bad_lines: int = 0,
    ) -> str:
        """One full dashboard frame as text.  ``heartbeat`` is the parsed
        per-rank file (or None); ``now_wall`` the wall clock used for its
        age — injectable so the golden test is deterministic."""
        lines = [
            f"run {self.run_id or '<no run_id>'} — {self.n_records} "
            f"record(s), {len(self.epochs)} epoch(s)"
            + (f", {self.alerts_fired} alert(s) fired" if self.alerts_fired else "")
            + (f", {bad_lines} torn line(s) skipped" if bad_lines else "")
        ]
        lines.append(
            f"{'epoch':>5} {'img/s':>9} {'p50_ms':>8} {'stall%':>7} "
            f"{'mfu':>6} {'goodput':>8} {'loss':>9} {'val_top1':>9}"
        )

        def fmt(v, spec, width):
            return (format(v, spec) if isinstance(v, (int, float)) else "-").rjust(width)

        for ep in sorted(self.epochs)[-self.rows:]:
            r = self.epochs[ep]
            p50 = r.get("step_time_p50")
            stall = r.get("data_stall_frac")
            lines.append(
                f"{ep:>5} {fmt(r.get('images_per_sec'), '.1f', 9)} "
                f"{fmt(p50 * 1e3 if isinstance(p50, (int, float)) else None, '.1f', 8)} "
                f"{fmt(stall * 100 if isinstance(stall, (int, float)) else None, '.1f', 7)} "
                f"{fmt(r.get('mfu'), '.3f', 6)} "
                f"{fmt(r.get('goodput_frac'), '.1%', 8)} "
                f"{fmt(r.get('loss'), '.4f', 9)} "
                f"{fmt(r.get('val_top1'), '.2f', 9)}"
            )
        for ev in self.events:
            lines.append(f"  {ev}")
        if heartbeat is not None:
            now = time.time() if now_wall is None else now_wall
            ts = heartbeat.get("ts")
            age = now - float(ts) if isinstance(ts, (int, float)) else None
            stale = isinstance(age, float) and age > STALE_AFTER_S
            lines.append(
                f"heartbeat: #{heartbeat.get('counter')} epoch "
                f"{heartbeat.get('epoch')} step {heartbeat.get('step')} "
                f"phase {heartbeat.get('phase')!r}"
                + (f", age {age:.1f}s" if age is not None else "")
                + (" — STALE" if stale else "")
            )
        elif self.finished and not self.crashed:
            lines.append("heartbeat: swept (clean exit)")
        if self.finished:
            # the exit line says HOW it ended: a clean run swept its
            # heartbeat and wrote its goodput totals; a crashed one left
            # a postmortem bundle behind instead
            lines.append(
                "run: CRASHED — postmortem bundle left behind"
                + (f" ({self.bundle})" if self.bundle else "")
                if self.crashed else "run: clean exit"
            )
        return "\n".join(lines)


def run_tail(
    log: str,
    *,
    heartbeat: Optional[str] = None,
    interval: float = 2.0,
    once: bool = False,
    rows: int = DEFAULT_ROWS,
    stream: Optional[TextIO] = None,
) -> int:
    """The ``obs tail`` loop: poll the log, redraw on growth, exit 0 when
    the run-end totals record lands (or on Ctrl-C).  ``once`` renders the
    current state and returns immediately (scripting / the golden CLI
    test).  Returns the process exit code."""
    import sys

    out = stream if stream is not None else sys.stdout
    follower = LogFollower(log)
    state = TailState(rows=rows)
    tty = hasattr(out, "isatty") and out.isatty()

    def frame() -> None:
        hb = heartbeat_lib.read(heartbeat) if heartbeat else None
        text = state.render(hb, bad_lines=follower.bad_lines)
        if tty:
            out.write("\x1b[2J\x1b[H")  # clear + home: a live dashboard
        out.write(text + "\n")
        out.flush()

    state.add(follower.poll())
    if once:
        frame()
        return 0 if state.n_records else 1
    frame()
    try:
        while not state.finished:
            time.sleep(interval)
            fresh = follower.poll()
            if fresh:
                state.add(fresh)
            frame()  # heartbeat age moves even when the log does not
    except KeyboardInterrupt:
        return 0  # the operator detached from the dashboard — clean exit
    return 0
