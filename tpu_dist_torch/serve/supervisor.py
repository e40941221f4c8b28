"""Replica supervision for the serving tier: the port's copy of
``tpu_dist/serve/supervisor.py`` (``ReplicaPolicy``,
``ReplicaSupervisor``), the same state machine and events.

* Crash: the supervisor owns the replica's process handle and polls its
  exit status. A non-zero exit (a SIGKILL shows as ``-9``) is a crash:
  the evidence directories are bundled through ``obs/postmortem.py``
  before the relaunch can overwrite anything, then the replica is
  respawned after the ``resilience/retry.py`` backoff, bounded by
  ``max_restarts``.
* Wedge: the replica's pump beats a heartbeat file
  (``ServingEngine(heartbeat_file=...)``). A beat older than
  ``stale_after_s``, or an unreadable one, on a live process is a wedge:
  SIGTERM, ``term_grace_s``, SIGKILL, bundle, relaunch. Before the first
  beat only ``warmup_grace_s`` applies; once a beat has been seen, an
  absent one is a clean exit's sweep, never a wedge. A beat another pid
  wrote (a SIGKILLed incarnation's, left behind) is not this
  incarnation's: unlike the JAX supervisor, the port does not judge a
  relaunched replica by it.
* Restore, not re-init: the relaunched replica loads its weights through
  the CRC-verified restore ladder (``load_serving_state``), so it serves
  the same bits (its ``ready`` line's ``weights_digest`` says so).
* The ``serve.replica_*`` counters count spawns, crashes, wedges,
  restarts, postmortems and a spent budget.

The spawn function and both clocks are injectable, so the tests and the
drill drive the whole state machine deterministically. ``capacity_file``
is the replica's allocation file (``fleet/capacity.py``): every spawn
event names the fleet decision that sized the replica (its
``decision_id``/``decision_cause``), when the file carries one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from tpu_dist_torch.elastic.supervisor import read_decision
from tpu_dist_torch.obs import counters as counters_lib
from tpu_dist_torch.resilience.retry import backoff_delays


@dataclasses.dataclass(frozen=True)
class ReplicaPolicy:
    """Supervision thresholds. ``stale_after_s`` is the fleet scheduler's
    default (one number means "dead" pod-wide) and must stay above the
    heartbeat's 1 s write throttle (``obs/heartbeat.py``);
    ``warmup_grace_s`` covers the replica's start-up (weights load and
    bucket warmup), during which no beat has landed yet and a wedge
    verdict would be premature."""

    max_restarts: int = 3
    stale_after_s: float = 60.0
    warmup_grace_s: float = 120.0
    term_grace_s: float = 5.0
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if min(self.stale_after_s, self.warmup_grace_s,
               self.term_grace_s) < 0:
            raise ValueError("grace windows must be >= 0")


class ReplicaSupervisor:
    """Supervise ONE serving replica process: crash/wedge detection,
    postmortem bundling, bounded auto-relaunch.

    ``spawn`` is ``(incarnation: int) -> handle`` where the handle is
    ``subprocess.Popen``-compatible (``poll() -> Optional[int]``,
    ``terminate()``, ``kill()``, ``pid``) — production passes a real
    Popen factory, the tests a deterministic fake. ``heartbeat_file``
    is the replica's rank-0 beat path (the replica itself derives
    per-rank names); ``postmortem_dirs`` are scanned by the bundle
    assembler on every crash/wedge. ``now``/``sleep`` are injectable
    for deterministic drills (``now`` must be the wall clock the
    heartbeat ``ts`` field is stamped on)."""

    def __init__(
        self,
        spawn: Callable[[int], object],
        *,
        heartbeat_file: Optional[str] = None,
        policy: Optional[ReplicaPolicy] = None,
        postmortem_dirs: Optional[List[str]] = None,
        now: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        on_event: Optional[Callable[[dict], None]] = None,
        capacity_file: Optional[str] = None,
    ):
        self._spawn = spawn
        self.heartbeat_file = heartbeat_file
        self.policy = policy or ReplicaPolicy()
        self.postmortem_dirs = list(postmortem_dirs or [])
        # the replica's allocation file: a spawn names the fleet decision
        # that sized the replica, when the file carries its tokens
        self.capacity_file = capacity_file
        self._now = now
        self._sleep = sleep
        self._on_event = on_event
        self._delays = backoff_delays(
            self.policy.max_restarts,
            self.policy.backoff_base_s,
            self.policy.backoff_max_s,
        )
        self.proc = None
        self.incarnation = 0
        self.restarts = 0
        self.done = False           # clean exit observed — supervision over
        self.gave_up = False        # restart budget exhausted
        self.last_rc: Optional[int] = None
        self.events: List[dict] = []
        self._spawned_at: Optional[float] = None
        self._beat_seen = False

    # -- events --------------------------------------------------------------

    def _event(self, kind: str, **extra) -> dict:
        ev = {"event": kind, "incarnation": self.incarnation, **extra}
        self.events.append(ev)
        if self._on_event is not None:
            self._on_event(ev)
        return ev

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Spawn the first incarnation (idempotent)."""
        if self.proc is None and not self.done and not self.gave_up:
            self._launch()

    def _launch(self) -> None:
        self.incarnation += 1
        self.proc = self._spawn(self.incarnation)
        self._spawned_at = self._now()
        self._beat_seen = False
        counters_lib.inc("serve.replica_spawns")
        ev: dict = {"pid": getattr(self.proc, "pid", None)}
        if self.capacity_file:
            meta = read_decision(self.capacity_file)
            if meta["decision_id"] is not None:
                ev["decision_id"] = meta["decision_id"]
                ev["decision_cause"] = meta["cause"]
        self._event("spawn", **ev)

    def _bundle(self, verdict_hint: str) -> Optional[str]:
        """Postmortem-bundle the evidence dirs through the existing
        flight/verdict machinery BEFORE a relaunch can overwrite them.
        Best-effort: a failed bundle must never block the relaunch."""
        if not self.postmortem_dirs:
            return None
        try:
            from tpu_dist_torch.obs import postmortem as postmortem_lib  # noqa: PLC0415

            report, bundle = postmortem_lib.run_postmortem(
                self.postmortem_dirs, annotate=True
            )
        except Exception as e:  # noqa: BLE001 — forensics never kill serving
            self._event("bundle_failed", error=repr(e), hint=verdict_hint)
            return None
        if bundle:
            counters_lib.inc("serve.replica_postmortems")
            self._event(
                "postmortem", bundle=bundle, hint=verdict_hint,
                n_ranks=report.get("n_ranks"),
            )
        return bundle

    def _relaunch_or_give_up(self, why: str) -> None:
        if self.restarts >= self.policy.max_restarts:
            self.gave_up = True
            self.proc = None
            counters_lib.inc("serve.replica_gave_up")
            self._event("gave_up", why=why, restarts=self.restarts)
            return
        delay = self._delays[self.restarts] if self._delays else 0.0
        self.restarts += 1
        counters_lib.inc("serve.replica_restarts")
        self._event("relaunch", why=why, restart=self.restarts,
                    backoff_s=delay)
        if delay:
            self._sleep(delay)
        self._launch()

    def _wedged(self) -> bool:
        """A live process whose beat went stale. Absent beat: only the
        warmup grace applies (the replica may still be compiling); once
        a beat has been SEEN, absence reads as a clean-exit sweep in
        progress, not a wedge. A beat that names another process's pid
        is a killed incarnation's, left behind, and counts as absent: the
        JAX supervisor reads it as this incarnation's, so a replica whose
        start-up outlasts ``stale_after_s`` after a crash is judged
        wedged before its first beat."""
        if self.heartbeat_file is None:
            return False
        from tpu_dist_torch.obs import heartbeat as heartbeat_lib  # noqa: PLC0415

        rec = heartbeat_lib.read(self.heartbeat_file)
        own = getattr(self.proc, "pid", None)
        if (rec is not None and own is not None and isinstance(rec.get("pid"), int)
                and rec["pid"] != own):
            rec = None
        now = self._now()
        if rec is None:
            if self._beat_seen:
                return False
            started = self._spawned_at if self._spawned_at is not None else now
            return now - started > self.policy.warmup_grace_s
        self._beat_seen = True
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool):
            # garbage beat: unreadable == stale (the read_signals rule)
            return True
        return now - float(ts) > self.policy.stale_after_s

    def _escalate(self) -> int:
        """SIGTERM → grace → SIGKILL a wedged replica; returns the exit
        status. The grace loop runs on the injectable clock so a drill
        can escalate instantly."""
        self.proc.terminate()
        deadline = self._now() + self.policy.term_grace_s
        while self._now() < deadline:
            rc = self.proc.poll()
            if rc is not None:
                return rc
            self._sleep(min(0.05, self.policy.term_grace_s or 0.05))
        self.proc.kill()
        while True:
            rc = self.proc.poll()
            if rc is not None:
                return rc
            self._sleep(0.05)

    def poll_once(self) -> Optional[str]:
        """One supervision step. Returns the event kind that fired
        (``"exit"``, ``"crash"``, ``"wedge"``, ``"gave_up"``) or None
        when the replica is simply healthy. Drive it from any loop —
        :meth:`run` is the batteries-included one."""
        if self.done or self.gave_up:
            return None
        if self.proc is None:
            self._launch()
            return None
        rc = self.proc.poll()
        if rc is not None:
            self.last_rc = rc
            if rc == 0:
                self.done = True
                self.proc = None
                self._event("exit", rc=0)
                return "exit"
            counters_lib.inc("serve.replica_crashes")
            self._event("crash", rc=rc)
            self._bundle(f"replica exit {rc}")
            self._relaunch_or_give_up(f"crash rc={rc}")
            return "gave_up" if self.gave_up else "crash"
        if self._wedged():
            counters_lib.inc("serve.replica_wedges")
            self._event("wedge")
            rc = self._escalate()
            self.last_rc = rc
            self._bundle("replica wedge (stale heartbeat)")
            self._relaunch_or_give_up("wedge")
            return "gave_up" if self.gave_up else "wedge"
        return None

    def run(self, poll_interval_s: float = 0.5,
            max_polls: Optional[int] = None) -> int:
        """Supervise until a clean exit or an exhausted budget; returns
        the final exit code (0 for clean, the last rc otherwise).
        ``max_polls`` bounds the loop for tests/drills."""
        self.start()
        polls = 0
        while not self.done and not self.gave_up:
            if max_polls is not None and polls >= max_polls:
                break
            self.poll_once()
            polls += 1
            if not self.done and not self.gave_up:
                self._sleep(poll_interval_s)
        return 0 if self.done else (self.last_rc or 1)
