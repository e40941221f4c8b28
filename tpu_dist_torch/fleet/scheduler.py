"""Chip arbitration across the runs sharing one pod: the port's copy of
``tpu_dist/fleet/scheduler.py`` (the arbiter and the chip-second audit).

* **Sensors**: each run's signals, scraped from what it already exports
  (its OpenMetrics exposition: data-stall fraction, goodput, MFU, the
  serving gauges and the active alerts; its heartbeat for liveness)
  through ``obs/hub.py::sample_run``, and typed into :class:`RunSignals`.
  The scheduler never instruments a run.
* **Policy** (:meth:`FleetScheduler.decide`), asymmetric by the run's
  ``kind``: training runs trade cards on goodput (at integer ``tick``
  decision points, a run data-stalled past ``donate_stall_frac`` donates
  toward a compute-bound one under ``receive_stall_frac``); a serving run
  whose SLO breach lasts ``serve_breach_ticks`` readings (an active
  ``slo_*`` alert, or its queue growing) is granted free cards, or
  preempts a trainer whatever its stall, and once healthy for
  ``serve_release_ticks`` readings it gives its surplus back. Donated
  cards are **pending until the next tick** (the donor needs its
  checkpoint and relaunch to vacate them). Hysteresis, a per-run move
  cooldown, the alert and liveness vetoes and each run's ``min_procs``
  keep it from thrashing. The function is pure: (state, tick, signals)
  to decisions, no clock, so every decision can be replayed from its
  recorded inputs.
* **Actuator**: a decision writes the runs' allocation files
  (``fleet/capacity.py``), with the decision's tokens; each run's
  launcher probe acts on it (the donor: SIGTERM, checkpoint, exit 75,
  relaunch smaller; the recipient: a grow). The scheduler signals no
  process itself.
* **Causal tracing**: each decision has a monotonic ``decision_id`` and
  a ``cause`` (``serve_breach``, ``serve_release``, ``goodput``); the
  grant that uses a donation's matured cards keeps the donation's id, so
  one id spans donate, SIGTERM, exit 75, relaunch and grant.
* **Audit**: each decision appends a ``fleet`` record (the allocations
  before and after, and every input that justified it), the
  ``fleet.allocation.<run>`` gauges and ``fleet.decisions`` counter, and
  an OpenMetrics exposition; each :meth:`FleetScheduler.step` appends a
  ``tenancy`` record, so ``sum(alloc) + free + pending == total_chips``
  at every tick and :func:`audit_chip_seconds` is exact.

The records are the JAX scheduler's field for field. Standard library
only: the arbiter runs wherever the metrics files are seen.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

from tpu_dist_torch.elastic.supervisor import feasible_sizes, grow_target, shrink_target
from tpu_dist_torch.fleet import capacity as capacity_lib
from tpu_dist_torch.obs import counters as counters_lib
from tpu_dist_torch.obs import export as export_lib
from tpu_dist_torch.obs import hub as hub_lib
from tpu_dist_torch.obs.hub import STALE_AFTER_S  # noqa: F401  (the scheduler's threshold)

#: ``fleet``/``tenancy`` records stamp the history's schema
#: (``metrics/history.py::SCHEMA_VERSION``, 15: the ``decision_id``/
#: ``decision_cause`` fields). A literal, so the scheduler imports no
#: torch; ``tests/test_torch_fleet.py`` pins it to the history's.
FLEET_SCHEMA_VERSION = 15

#: The run classes the arbiter understands (``RunSpec.kind``).
RUN_KINDS = ("train", "serve")

#: The causal tags a decision can carry — WHY the chips moved.
DECISION_CAUSES = ("serve_breach", "serve_release", "goodput")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One gang-scheduled run: its name, the size it was submitted at
    (``original`` — also its ceiling: the arbiter never grows a run past
    what it asked for), its floor, and its class. ``kind`` selects the
    policy half that governs it: ``train`` runs trade chips on goodput
    (stall fractions), ``serve`` runs on SLO state (breach/release
    streaks)."""

    name: str
    original: int
    min_procs: int = 1
    kind: str = "train"

    def __post_init__(self):
        if self.original <= 0:
            raise ValueError(f"{self.name}: original size must be positive")
        if not 1 <= self.min_procs <= self.original:
            raise ValueError(
                f"{self.name}: min_procs {self.min_procs} outside "
                f"[1, {self.original}]"
            )
        if self.kind not in RUN_KINDS:
            raise ValueError(
                f"{self.name}: kind {self.kind!r} not in {RUN_KINDS}"
            )


@dataclasses.dataclass(frozen=True)
class RunSignals:
    """One run's scraped sensor readings at a decision point. ``None``
    means the signal is absent (run not exporting yet) — absent signals
    make a run ineligible for moves in either direction rather than
    defaulting to a number."""

    run: str
    data_stall_frac: Optional[float] = None
    goodput_frac: Optional[float] = None
    mfu: Optional[float] = None
    active_alerts: Tuple[str, ...] = ()
    heartbeat_age_s: Optional[float] = None
    alive: Optional[bool] = None  # None = no liveness source configured
    epoch: Optional[float] = None
    # the serving sensor triplet (serve/slo.py scalars — published by
    # ServingEngine.record_window): demand, health, and the p99 bound
    queue_depth: Optional[float] = None
    availability: Optional[float] = None
    latency_p99_ms: Optional[float] = None

    def to_record(self) -> dict:
        out = {
            k: v
            for k, v in dataclasses.asdict(self).items()
            if k != "run" and v is not None and v != ()
        }
        if self.active_alerts:
            out["active_alerts"] = list(self.active_alerts)
        return out


def signals_from_sample(sample: dict) -> RunSignals:
    """Type one hub sample (``obs/hub.py::sample_run`` — or one entry
    of a :meth:`TelemetryHub.collect` snapshot's ``runs``) into
    :class:`RunSignals`. The ONE place the arbiter's gauge vocabulary
    lives — the scheduler never parses an exposition itself."""
    vals = sample.get("values") or {}

    def gauge(raw: str) -> Optional[float]:
        return vals.get(export_lib.metric_name(raw))

    return RunSignals(
        run=sample["run"],
        data_stall_frac=gauge("train.data_stall_frac"),
        goodput_frac=gauge("goodput.goodput_frac"),
        mfu=gauge("train.mfu"),
        active_alerts=tuple(export_lib.active_labels(vals)),
        heartbeat_age_s=sample.get("heartbeat_age_s"),
        alive=sample.get("alive"),
        epoch=gauge("train.epoch"),
        queue_depth=gauge("serve.queue_depth"),
        availability=gauge("serve.availability"),
        latency_p99_ms=gauge("serve.latency_p99_ms"),
    )


def read_signals(
    run: str,
    metrics_file: str,
    heartbeat_file: Optional[str] = None,
    now: Optional[float] = None,
) -> RunSignals:
    """One run's :class:`RunSignals`, scraped **via the hub's sample
    primitive** (``obs/hub.py::sample_run`` — the one scrape fan-in; an
    absent or torn exposition degrades to all-None signals, a stale or
    garbage heartbeat fails closed to ``alive=False``, never raises).
    (A pod-scale arbiter reads one hub snapshot through
    ``signals_from_hub``, which waits with the hub: the package
    docstring.)"""
    return signals_from_sample(hub_lib.sample_run(
        run,
        metrics_file=metrics_file,
        heartbeat_file=heartbeat_file,
        now=now,
    ))


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """The arbitration thresholds (docs/resilience.md for semantics)."""

    donate_stall_frac: float = 0.40   # a run stalled past this donates
    receive_stall_frac: float = 0.10  # a recipient must be under this
    hysteresis: float = 0.05          # extra margin to reverse a move
    move_cooldown: int = 2            # ticks a moved run sits out
    # -- the serve half of the asymmetric policy ----------------------------
    # a serving SLO breach must be SUSTAINED this many consecutive
    # readings before it preempts training chips (one noisy window must
    # not SIGTERM a trainer) — the documented preemption-latency bound
    # is serve_breach_ticks ticks to the donor's SIGTERM (its probe
    # fires within one interval of the allocation-file shrink) plus two
    # ticks (pending maturation + grant) to the chips landing
    serve_breach_ticks: int = 2
    # ...and must stay CLEAR this many readings before the serve run
    # releases its surplus back to training (the off-peak reclaim) —
    # the serve-side hysteresis against diurnal-edge thrash
    serve_release_ticks: int = 3
    # queue-depth growth of at least this much across consecutive
    # readings counts as a breach signal even before an slo_* alert
    # fires (the queue explodes faster than a p99 histogram converges)
    serve_queue_growth: float = 1.0
    # a serve run is "healthy" (release-streak eligible) only while its
    # queue is at most this deep and availability is at least this high
    serve_idle_queue: float = 1.0
    serve_ok_availability: float = 0.99

    def __post_init__(self):
        if not 0.0 <= self.receive_stall_frac < self.donate_stall_frac <= 1.0:
            raise ValueError(
                "need 0 <= receive_stall_frac < donate_stall_frac <= 1 "
                f"(got {self.receive_stall_frac} / {self.donate_stall_frac})"
            )
        if self.hysteresis < 0 or self.move_cooldown < 0:
            raise ValueError("hysteresis and move_cooldown must be >= 0")
        if self.serve_breach_ticks < 1 or self.serve_release_ticks < 1:
            raise ValueError(
                "serve_breach_ticks and serve_release_ticks must be >= 1"
            )
        if (
            self.serve_queue_growth <= 0
            or self.serve_idle_queue < 0
            or not 0.0 <= self.serve_ok_availability <= 1.0
        ):
            raise ValueError(
                "need serve_queue_growth > 0, serve_idle_queue >= 0, "
                "serve_ok_availability in [0, 1]"
            )


class FleetScheduler:
    """Gang-schedule N runs on one pod and arbitrate their chips.

    ``fleet_dir`` (optional) is where the actuator lives: each run's
    allocation file at ``<fleet_dir>/<run>/allocation`` and the audit
    log at ``<fleet_dir>/fleet.jsonl``. Constructed without it, the
    scheduler is a pure policy object (the unit-test mode).
    """

    def __init__(
        self,
        runs: List[RunSpec],
        *,
        policy: Optional[FleetPolicy] = None,
        fleet_dir: Optional[str] = None,
        total_chips: Optional[int] = None,
        allocations: Optional[Dict[str, int]] = None,
    ):
        if not runs:
            raise ValueError("a fleet needs at least one run")
        names = [r.name for r in runs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate run names: {names}")
        self.specs: Dict[str, RunSpec] = {r.name: r for r in runs}
        self.policy = policy or FleetPolicy()
        self.fleet_dir = fleet_dir
        self.alloc: Dict[str, int] = {}
        for r in runs:
            a = (allocations or {}).get(r.name, r.original)
            if a not in feasible_sizes(r.original) or a < r.min_procs:
                raise ValueError(
                    f"{r.name}: allocation {a} is not a feasible size of "
                    f"{r.original} (or under min_procs {r.min_procs})"
                )
            self.alloc[r.name] = a
        allocated = sum(self.alloc.values())
        self.total_chips = (
            int(total_chips) if total_chips is not None else allocated
        )
        if self.total_chips < allocated:
            raise ValueError(
                f"total_chips {self.total_chips} < initial allocations "
                f"{allocated}"
            )
        self.free = self.total_chips - allocated
        # chips freed by a donation are PENDING until the next tick: the
        # donor needs its SIGTERM->checkpoint->relaunch window to actually
        # vacate them, and granting in the same instant would transiently
        # oversubscribe the pool (the recipient's probe can fire first
        # and relaunch onto chips the donor still holds). Decision points
        # are epoch-grain and the donor's resize completes within a probe
        # interval, so one-tick maturation closes the window.
        self.pending = 0
        self._pending_since: Optional[int] = None
        self._last_move_tick: Dict[str, int] = {}
        self._last_move_dir: Dict[str, str] = {}  # 'donated' | 'received'
        self.decisions = 0
        self.preemptions = 0
        # causal arbitration tracing: every decision carries a monotonic
        # decision_id. decide() stays pure — it READS the next id (and
        # the matured-donation id below); apply() advances the counter.
        self._next_decision_id = 1
        self.last_decision_id = 0
        # the donation currently maturing in the pending pool, and the
        # matured donation whose chips now sit in the free pool: the
        # FIRST grant after maturation reuses that id — the grant is the
        # completion leg of arbitration N, not a new arbitration — so
        # one decision_id spans donate→SIGTERM→exit-75→relaunch→grant
        self._pending_decision_id: Optional[int] = None
        self._matured_decision_id: Optional[int] = None
        # the serve-policy streak state — derived DETERMINISTICALLY from
        # the signal sequence by note_signals (step drives it), so a
        # replay of the recorded inputs reproduces every decision
        self._breach_streak: Dict[str, int] = {}
        self._healthy_streak: Dict[str, int] = {}
        self._last_queue_depth: Dict[str, float] = {}
        if fleet_dir:
            os.makedirs(fleet_dir, exist_ok=True)
            for name, a in self.alloc.items():
                capacity_lib.write_allocation(self.allocation_path(name), a)
        self._publish_gauges()

    # -- paths ---------------------------------------------------------------

    def allocation_path(self, run: str) -> str:
        if not self.fleet_dir:
            raise ValueError("scheduler constructed without a fleet_dir")
        return os.path.join(self.fleet_dir, run, "allocation")

    def history_path(self) -> str:
        if not self.fleet_dir:
            raise ValueError("scheduler constructed without a fleet_dir")
        return os.path.join(self.fleet_dir, "fleet.jsonl")

    # -- policy --------------------------------------------------------------

    def _in_cooldown(self, run: str, tick: int) -> bool:
        last = self._last_move_tick.get(run)
        return last is not None and tick - last <= self.policy.move_cooldown

    # -- the serve half: breach/release streaks ------------------------------

    def _serve_breached(self, run: str, sig: RunSignals) -> bool:
        """One reading's breach verdict: any active ``slo_*`` alert
        (serve/slo.py SLO_BUILTINS — p99/p50/TTFB/availability/rps/
        queue), or the queue growing across consecutive readings (the
        early-warning signal — a queue explodes faster than a p99
        histogram converges)."""
        if any(a.startswith("slo_") for a in sig.active_alerts):
            return True
        q, last = sig.queue_depth, self._last_queue_depth.get(run)
        return (
            q is not None and last is not None
            and q - last >= self.policy.serve_queue_growth
        )

    def _serve_healthy(self, run: str, sig: RunSignals) -> bool:
        """One reading's release-eligibility verdict: no breach signal,
        queue at idle depth, availability over the bar (an absent
        availability — no completed requests yet in the window — reads
        as healthy only alongside an idle queue)."""
        if self._serve_breached(run, sig):
            return False
        if sig.queue_depth is None or sig.queue_depth > self.policy.serve_idle_queue:
            return False
        return (
            sig.availability is None
            or sig.availability >= self.policy.serve_ok_availability
        )

    def note_signals(self, signals: Dict[str, RunSignals]) -> None:
        """Advance each serve run's breach/release streaks from one
        reading. :meth:`step` calls this before :meth:`decide`; drive it
        yourself (in signal order) when replaying recorded inputs
        through :meth:`decide` directly. A run with no reading holds
        its streaks — absent evidence neither escalates nor clears."""
        for run, spec in self.specs.items():
            if spec.kind != "serve":
                continue
            sig = signals.get(run)
            if sig is None:
                continue
            if self._serve_breached(run, sig):
                self._breach_streak[run] = self._breach_streak.get(run, 0) + 1
                self._healthy_streak[run] = 0
            elif self._serve_healthy(run, sig):
                self._healthy_streak[run] = (
                    self._healthy_streak.get(run, 0) + 1
                )
                self._breach_streak[run] = 0
            else:
                # neither breached nor idle-healthy (e.g. busy but
                # within SLO): both streaks reset — no escalation, no
                # release
                self._breach_streak[run] = 0
                self._healthy_streak[run] = 0
            if sig.queue_depth is not None:
                self._last_queue_depth[run] = sig.queue_depth

    def _serve_wants_chips(self, run: str, sig: Optional[RunSignals],
                           tick: int) -> bool:
        """A serve run whose breach streak crossed the sustained bar and
        that can still grow. Deliberately NOT cooldown-gated: the
        breach streak is itself the thrash guard, and the preemption-
        latency contract cannot hide a cooldown inside it."""
        spec = self.specs[run]
        if spec.kind != "serve" or self.alloc[run] >= spec.original:
            return False
        if sig is None or sig.alive is False:
            return False
        if any(not a.startswith("slo_") for a in sig.active_alerts):
            # asymmetric alert veto: slo_* alerts ARE the demand signal,
            # but a non-SLO alert (serve_retrace, heartbeat_stale...)
            # means the replica is sick — chips won't fix that
            return False
        return (
            self._breach_streak.get(run, 0) >= self.policy.serve_breach_ticks
        )

    def _serve_can_release(self, run: str, sig: Optional[RunSignals],
                           tick: int) -> bool:
        """A serve run healthy long enough to hand its surplus back."""
        spec = self.specs[run]
        if spec.kind != "serve" or self.alloc[run] <= spec.min_procs:
            return False
        if shrink_target(
            spec.original, self.alloc[run], self.alloc[run] - 1, spec.min_procs
        ) is None:
            return False
        if self._in_cooldown(run, tick):
            return False
        if sig is None or sig.alive is False:
            return False
        return (
            self._healthy_streak.get(run, 0) >= self.policy.serve_release_ticks
        )

    # -- the train half: stall-fraction thresholds ---------------------------

    def _donor_ok(self, run: str, sig: Optional[RunSignals], tick: int) -> bool:
        spec = self.specs[run]
        if spec.kind == "serve":
            # a serve run donates on its release streak, not on stall
            return self._serve_can_release(run, sig, tick)
        if self.alloc[run] <= spec.min_procs:
            return False
        if shrink_target(
            spec.original, self.alloc[run], self.alloc[run] - 1, spec.min_procs
        ) is None:
            return False
        if self._in_cooldown(run, tick):
            return False
        if sig is None or sig.alive is False:
            return False
        stall = sig.data_stall_frac
        if stall is None:
            return False
        threshold = self.policy.donate_stall_frac
        if self._last_move_dir.get(run) == "received":
            # hysteresis: reversing a receive needs extra conviction
            threshold += self.policy.hysteresis
        return stall >= threshold

    def _recipient_ok(self, run: str, sig: Optional[RunSignals], tick: int) -> bool:
        spec = self.specs[run]
        if spec.kind == "serve":
            return False  # serve runs grow only through the breach path
        if self.alloc[run] >= spec.original:
            return False
        if self._in_cooldown(run, tick):
            return False
        if sig is None or sig.alive is False:
            return False
        if sig.active_alerts:
            return False  # alert-veto: never feed chips to a sick run
        stall = sig.data_stall_frac
        if stall is None:
            return False
        threshold = self.policy.receive_stall_frac
        if self._last_move_dir.get(run) == "donated":
            threshold -= self.policy.hysteresis
        return stall <= threshold

    def _preempt_donor(self, recipient: str, signals: Dict[str, RunSignals],
                       tick: int) -> Optional[Tuple[str, int]]:
        """Pick the training run to shrink for a breached serve run:
        prefer the most data-stalled (its chips buy the least), but —
        unlike the goodput path — a compute-bound trainer is preempted
        too when it is all there is: the SLO outranks goodput. Floors,
        shrink feasibility and liveness still hold; the donor cooldown
        does NOT (it would add unbounded ticks to the preemption-latency
        contract). Returns ``(donor, target_size)`` or None."""
        rspec = self.specs[recipient]
        rcur = self.alloc[recipient]
        candidates = sorted(
            (r for r, s in self.specs.items() if s.kind == "train"),
            key=lambda r: (
                -(signals[r].data_stall_frac or 0.0)
                if r in signals and signals[r] is not None else 0.0,
                r,
            ),
        )
        for donor in candidates:
            sig = signals.get(donor)
            if sig is None or sig.alive is False:
                continue
            dspec = self.specs[donor]
            dcur = self.alloc[donor]
            # smallest sufficient shrink: walk the donor's feasible
            # sizes largest-first and take the first whose freed chips
            # make the serve grow reachable — a preemption must actually
            # buy the replica set its next bucket, not just wound the
            # trainer
            for dtarget in sorted(
                (s for s in feasible_sizes(dspec.original)
                 if dspec.min_procs <= s < dcur),
                reverse=True,
            ):
                if grow_target(
                    rspec.original, rcur,
                    rcur + self.free + self.pending + (dcur - dtarget),
                    rspec.original,
                ) is not None:
                    return donor, dtarget
        return None

    def mature_pending(self, tick: int) -> None:
        """Fold chips a donor freed at an EARLIER tick into the grantable
        pool — by the next epoch-grain decision point the donor's probe
        has long since relaunched it at the smaller size, so the chips
        are genuinely vacant. :meth:`step` calls this; drive it yourself
        when using :meth:`decide`/:meth:`apply` directly."""
        if self._pending_since is not None and tick > self._pending_since:
            self.free += self.pending
            self.pending = 0
            self._pending_since = None
            # the donation's id rides with its chips into the free pool:
            # the next grant completes that arbitration under the same id
            self._matured_decision_id = self._pending_decision_id
            self._pending_decision_id = None
            self._publish_gauges()

    def decide(
        self, tick: int, signals: Dict[str, RunSignals]
    ) -> List[dict]:
        """One decision point: pure policy over the scraped signals (no
        state mutated — :meth:`step` applies + audits). At most one
        decision per tick (epoch-grain pacing; the cooldown makes more
        pointless anyway): a **grant** grows the best compute-bound
        recipient from the FREE pool; when the pool is empty a
        **donation** shrinks the worst stalled donor, banking its chips
        as pending until the next tick — never both at once, so the
        allocations on disk never sum past the chips that are actually
        vacant (the donor needs its checkpoint/relaunch window to vacate
        them).

        Serve-breach arbitration runs FIRST: a serve run whose breach
        streak crossed ``serve_breach_ticks`` is granted from the free
        pool when chips are vacant, else a training donor is preempted
        (shrunk regardless of stall) — SLO demand outranks every
        goodput move. Off-peak the release streak turns the serve run
        into an ordinary donor and the existing recipient-driven
        donate/grant discipline reclaims the chips for training."""
        # -- priority 1: a sustained serving SLO breach claims chips ----
        breached = sorted(
            (r for r in self.specs
             if self._serve_wants_chips(r, signals.get(r), tick)),
            key=lambda r: (-self._breach_streak.get(r, 0), r),
        )
        for run in breached:
            spec = self.specs[run]
            cur = self.alloc[run]
            target = grow_target(
                spec.original, cur, cur + self.free, spec.original
            )
            if target is not None:
                return [self._grant_decision(
                    tick, signals, run, target, preempt=True
                )]
            picked = self._preempt_donor(run, signals, tick)
            if picked is not None:
                donor, dtarget = picked
                return [self._donate_decision(
                    tick, signals, donor, dtarget, for_run=run, preempt=True
                )]
        # -- priority 2: the goodput market (train↔train, plus serve
        # runs releasing surplus off-peak via _donor_ok) ----------------
        donors = sorted(
            (r for r in self.specs if self._donor_ok(r, signals.get(r), tick)),
            key=lambda r: (-(signals[r].data_stall_frac or 0.0), r),
        )
        recipients = sorted(
            (r for r in self.specs
             if self._recipient_ok(r, signals.get(r), tick)),
            key=lambda r: (signals[r].data_stall_frac or 0.0, r),
        )
        recipients = [r for r in recipients if r not in donors]
        for recipient in recipients:
            spec = self.specs[recipient]
            cur = self.alloc[recipient]
            target = grow_target(
                spec.original, cur, cur + self.free, spec.original
            )
            if target is not None:
                return [self._grant_decision(
                    tick, signals, recipient, target
                )]
            # the recipient is starved and the pool is dry: bank the
            # worst donor's chips for the NEXT tick (a donation without
            # demand never happens — chips would just idle)
            for donor in donors:
                dspec = self.specs[donor]
                dcur = self.alloc[donor]
                if dspec.kind == "serve":
                    # an off-peak release may need more than one
                    # feasible step at once (the trainer's next size up
                    # can be far away) — take the smallest sufficient
                    # shrink, largest target first
                    targets = sorted(
                        (s for s in feasible_sizes(dspec.original)
                         if dspec.min_procs <= s < dcur),
                        reverse=True,
                    )
                else:
                    one = shrink_target(
                        dspec.original, dcur, dcur - 1, dspec.min_procs
                    )
                    targets = [one] if one is not None else []
                for dtarget in targets:
                    freed = dcur - dtarget
                    if grow_target(
                        spec.original, cur,
                        cur + self.free + self.pending + freed, spec.original,
                    ) is None:
                        continue  # would never reach a feasible grow
                    return [self._donate_decision(
                        tick, signals, donor, dtarget, for_run=recipient
                    )]
        return []

    def _base_record(self, tick: int, signals: Dict[str, RunSignals]) -> dict:
        rec = {
            "kind": "fleet",
            "schema_version": FLEET_SCHEMA_VERSION,
            "tick": int(tick),
            "inputs": {
                r: signals[r].to_record() for r in sorted(signals)
            },
            "policy": dataclasses.asdict(self.policy),
        }
        streaks = {
            r: {
                "breach": self._breach_streak.get(r, 0),
                "healthy": self._healthy_streak.get(r, 0),
            }
            for r, s in sorted(self.specs.items()) if s.kind == "serve"
        }
        if streaks:
            rec["serve_streaks"] = streaks
        return rec

    def _grant_decision(
        self, tick: int, signals: Dict[str, RunSignals],
        recipient: str, recipient_to: int, preempt: bool = False,
    ) -> dict:
        before = dict(self.alloc)
        after = dict(before)
        after[recipient] = recipient_to
        moved = recipient_to - before[recipient]
        rsig = signals.get(recipient)
        if preempt:
            reason = (
                f"sustained SLO breach "
                f"({self._breach_streak.get(recipient, 0)} reading(s)) — "
                f"free pool staffs breached serve run {recipient}"
                + (
                    f" (queue {rsig.queue_depth:g})"
                    if rsig is not None and rsig.queue_depth is not None
                    else ""
                )
            )
        else:
            reason = "free pool staffs compute-bound " + recipient + (
                f" (stall {rsig.data_stall_frac:.0%})"
                if rsig is not None and rsig.data_stall_frac is not None
                else ""
            )
        # a grant that consumes chips matured out of a donation is the
        # COMPLETION of that arbitration: reuse its id (one decision_id
        # spans the whole donate→…→grant chain); a grant from original
        # free-pool slack is its own fresh arbitration
        chained = self._matured_decision_id is not None
        return {
            **self._base_record(tick, signals),
            "action": "grant",
            "decision_id": (
                self._matured_decision_id if chained
                else self._next_decision_id
            ),
            "cause": "serve_breach" if preempt else "goodput",
            "chained": chained,
            "donor": None,
            "recipient": recipient,
            "chips": int(moved),
            "preempt": bool(preempt),
            "alloc_before": before,
            "alloc_after": after,
            "free_before": self.free,
            "free_after": self.free - moved,
            "pending_after": self.pending,
            "reason": reason,
        }

    def _donate_decision(
        self, tick: int, signals: Dict[str, RunSignals],
        donor: str, donor_to: int, for_run: str, preempt: bool = False,
    ) -> dict:
        before = dict(self.alloc)
        after = dict(before)
        after[donor] = int(donor_to)
        freed = before[donor] - after[donor]
        dsig = signals.get(donor)
        fsig = signals.get(for_run)
        if preempt:
            reason = (
                f"sustained SLO breach on {for_run} "
                f"({self._breach_streak.get(for_run, 0)} reading(s)) "
                f"preempts {freed} chip(s) from trainer {donor} "
                "(SIGTERM→emergency-save→exit-75) — grantable next tick"
            )
        elif self.specs[donor].kind == "serve":
            reason = (
                f"serve run {donor} healthy "
                f"{self._healthy_streak.get(donor, 0)} reading(s) releases "
                f"{freed} chip(s) toward compute-bound {for_run}"
                + (
                    f" (stall {fsig.data_stall_frac:.0%})"
                    if fsig is not None and fsig.data_stall_frac is not None
                    else ""
                )
                + " — grantable next tick"
            )
        else:
            reason = (
                f"{donor} "
                + (
                    f"{dsig.data_stall_frac:.0%} "
                    if dsig is not None and dsig.data_stall_frac is not None
                    else ""
                )
                + f"data-stalled donates {freed} chip(s) toward "
                f"compute-bound {for_run}"
                + (
                    f" (stall {fsig.data_stall_frac:.0%})"
                    if fsig is not None and fsig.data_stall_frac is not None
                    else ""
                )
                + " — grantable next tick"
            )
        if preempt:
            cause = "serve_breach"
        elif self.specs[donor].kind == "serve":
            cause = "serve_release"
        else:
            cause = "goodput"
        return {
            **self._base_record(tick, signals),
            "action": "donate",
            "decision_id": self._next_decision_id,
            "cause": cause,
            "chained": False,
            "donor": donor,
            "recipient": None,
            "for_run": for_run,
            "chips": int(freed),
            "preempt": bool(preempt),
            "alloc_before": before,
            "alloc_after": after,
            "free_before": self.free,
            "free_after": self.free,
            "pending_after": self.pending + freed,
            "reason": reason,
        }

    # -- actuation + audit ---------------------------------------------------

    def apply(self, decision: dict, tick: int) -> None:
        """Commit one decision: allocations, cooldown/hysteresis state,
        pending/free pools, decision-id bookkeeping, gauges, allocation
        files (written WITH the decision metadata tokens — the donor's
        supervisor reads them back into the relaunch env, which is how
        the id crosses the process boundary)."""
        after = decision["alloc_after"]
        did = int(decision.get("decision_id") or self._next_decision_id)
        cause = decision.get("cause")
        for run in self.specs:
            if after[run] != self.alloc[run]:
                self._last_move_tick[run] = tick
                self._last_move_dir[run] = (
                    "donated" if after[run] < self.alloc[run] else "received"
                )
                self.alloc[run] = after[run]
                if self.fleet_dir:
                    capacity_lib.write_allocation(
                        self.allocation_path(run), after[run],
                        decision_id=did, cause=cause,
                    )
        self.free = decision["free_after"]
        if decision.get("action") == "donate":
            self.pending = decision["pending_after"]
            self._pending_since = tick
            self._pending_decision_id = did
        elif did == self._matured_decision_id:
            # the matured donation's completion grant just fired — the
            # chain is closed, the next grant is a fresh arbitration
            self._matured_decision_id = None
        self._next_decision_id = max(self._next_decision_id, did + 1)
        self.last_decision_id = did
        self.decisions += 1
        counters_lib.inc("fleet.decisions")
        if decision.get("preempt"):
            self.preemptions += 1
            counters_lib.inc("fleet.preemptions")
        self._publish_gauges()

    def tenancy_record(self, tick: int) -> dict:
        """One per-tick chip-accounting snapshot (``tenancy`` history
        kind, schema v15): every run's allocation plus the free and
        pending pools, stamped with the id of the LAST arbitration that
        shaped them (``decision_id`` — 0 until the first move; the
        ``obs pod`` chip-ownership Gantt reads the ticks off these).
        ``sum(alloc) + free + pending == total_chips`` holds at every
        tick (the pools are conserved by construction), which is what
        makes :func:`audit_chip_seconds` exact rather than
        approximate."""
        return {
            "kind": "tenancy",
            "schema_version": FLEET_SCHEMA_VERSION,
            "tick": int(tick),
            "alloc": dict(self.alloc),
            "free": int(self.free),
            "pending": int(self.pending),
            "total_chips": int(self.total_chips),
            "run_kinds": {r: s.kind for r, s in sorted(self.specs.items())},
            "decision_id": int(self.last_decision_id),
        }

    def step(
        self,
        tick: int,
        signals: Dict[str, RunSignals],
        ts: Optional[float] = None,
    ) -> List[dict]:
        """mature pending → note serve streaks → decide → apply → audit
        (every decision PLUS one per-tick ``tenancy`` snapshot). ``ts``
        annotates the records for humans and cross-run joins; the
        POLICY never reads it (reproducibility contract)."""
        self.mature_pending(tick)
        self.note_signals(signals)
        decisions = self.decide(tick, signals)
        now = time.time() if ts is None else ts
        for d in decisions:
            self.apply(d, tick)
            if self.fleet_dir:
                rec = dict(d)
                rec["ts"] = now
                with open(self.history_path(), "a") as f:
                    f.write(json.dumps(rec) + "\n")
        if self.fleet_dir:
            rec = self.tenancy_record(tick)
            rec["ts"] = now
            with open(self.history_path(), "a") as f:
                f.write(json.dumps(rec) + "\n")
        return decisions

    def _publish_gauges(self) -> None:
        for run, a in self.alloc.items():
            counters_lib.set_gauge(f"fleet.allocation.{run}", a)
        counters_lib.set_gauge("fleet.free_chips", self.free)
        counters_lib.set_gauge("fleet.pending_chips", self.pending)

    def exposition(self) -> str:
        """The scheduler's own OpenMetrics exposition:
        ``tpu_dist_fleet_allocation{run="..."}`` samples plus the
        decision counter — scrape-able next to the runs it arbitrates."""
        return export_lib.render(
            {
                "fleet.decisions": self.decisions,
                "fleet.preemptions": self.preemptions,
                "fleet.free_chips": self.free,
                "fleet.pending_chips": self.pending,
                # the hub's chip rollups and the pod-level decision
                # cursor read these two off the scraped ledger
                "fleet.total_chips": self.total_chips,
                "fleet.last_decision_id": self.last_decision_id,
            },
            labeled={"fleet_allocation": dict(self.alloc)},
            label_keys={"fleet_allocation": "run"},
        )

    def write_exposition(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as f:
            f.write(self.exposition())
        os.replace(tmp, path)


# -- chip-second accounting ---------------------------------------------------


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
