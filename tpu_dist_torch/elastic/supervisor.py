"""The elastic relaunch policy of the launcher (``cli/launch.py``): the
port's copy of ``tpu_dist/elastic/supervisor.py``.

On a shared or preemptible pool, losing part of a run is routine: a run
that can go on at a smaller world survives where one that needs its exact
size waits in the queue. This module is the policy, pure and
deterministic; the launcher is the mechanism (spawn a round of workers,
collect each rank's exit).

The loop:

1. Run a round at world size ``n``.
2. A clean exit ends the run. Otherwise each rank's exit is classed: one
   that ended 0, with the preemption code (75) or on the launcher's own
   forwarded SIGTERM is a **survivor** (it can be rescheduled); any other
   (a hard kill, a crash, the watchdog's SIGKILL) is **lost**.
3. A preemption of the whole world (nothing lost) relaunches at the same
   size; lost ranks shrink the next round to the largest divisor of the
   ORIGINAL world that the survivors can staff, at least ``min_procs``
   (a divisor keeps the global batch divisible).
4. Each relaunch waits the deterministic backoff of
   ``resilience/retry.py`` (no jitter, the sleep injectable) and counts
   against ``max_restarts``: a deterministic crash loop spends its budget
   and surfaces the real exit code.

Growing back is the other half: a shrunken run stays small unless someone
notices that the cards came back. A :class:`CapacityProbe` (an injectable
census and clock, a fixed probe interval and a deterministic cooldown
between grows) is polled by the RUNNING round; when the census staffs a
larger divisor, the round checkpoints its world (SIGTERM, exit 75) and
reports ``resize_to``, and the loop relaunches with ``--resume`` at the
new size. Resizes are voluntary: they charge no restart budget and wait
no backoff. The same probe carries the fleet scheduler's donations (the
census fell below the current size), and on a FAILURE relaunch the census
caps the survivors' size, so a round never respawns onto cards another
run was given.

The state side (the checkpoint re-laid onto the new extent, the epoch's
remaining examples) is ``elastic/remap.py`` and the trainer's restore;
the relaunched children just run ``--resume``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, Dict, Optional

from tpu_dist_torch.resilience.preemption import PREEMPTION_EXIT_CODE
from tpu_dist_torch.resilience.retry import backoff_delays

#: Exit statuses of a rank that can be rescheduled: clean, the cooperative
#: preemption code, and death by the launcher's own forwarded SIGTERM (a
#: child stopped before its handler was installed).
SURVIVOR_EXITS = frozenset({0, PREEMPTION_EXIT_CODE, -int(signal.SIGTERM)})

#: The relaunch environment's names for the fleet decision that moved the
#: run: when the scheduler resized it, the allocation file carries its
#: ``decision_id``/``cause`` tokens and the launcher stamps them into
#: every relaunched child (the trainer's ``resume`` record, its flight
#: ring and its ``fleet.decision_id`` gauge name the decision). A
#: relaunch after a lost card has neither.
DECISION_ID_ENV = "TPU_DIST_FLEET_DECISION_ID"
DECISION_CAUSE_ENV = "TPU_DIST_FLEET_DECISION_CAUSE"


def read_decision(capacity_file: Optional[str]) -> dict:
    """The decision tokens in the run's allocation file: ``{"decision_id":
    int|None, "cause": str|None}``, both None without a file, with an
    absent or torn one, or one written without tokens. Never raises."""
    if not capacity_file:
        return {"decision_id": None, "cause": None}
    from tpu_dist_torch.fleet import capacity as capacity_lib  # noqa: PLC0415

    return capacity_lib.read_allocation_meta(capacity_file)


def stamp_decision_env(env: dict, capacity_file: Optional[str]) -> dict:
    """Write the file's ``decision_id``/``cause`` into a relaunch
    environment in place, and remove them where the file has none (a
    child relaunched after the decision must not inherit a stale id from
    the launcher's own environment). Returns what was read."""
    meta = read_decision(capacity_file)
    for key, val in ((DECISION_ID_ENV, meta["decision_id"]),
                     (DECISION_CAUSE_ENV, meta["cause"])):
        if val is not None:
            env[key] = str(val)
        else:
            env.pop(key, None)
    return meta


def decision_from_env(env: Optional[dict] = None) -> dict:
    """The other end of :func:`stamp_decision_env`: the decision a child's
    launch carries out, read from ``env`` (default ``os.environ``) as the
    trainer records it, ``{"decision_id": int, "decision_cause": str}``,
    the cause only beside an id; empty for a launch no fleet decision made
    (a lost card) or an id that is not an integer."""
    env = os.environ if env is None else env
    try:
        raw = env.get(DECISION_ID_ENV, "")
        did = int(raw) if raw else None
    except ValueError:
        did = None
    if did is None:
        return {}
    cause = env.get(DECISION_CAUSE_ENV) or None
    return {"decision_id": did, **({"decision_cause": cause} if cause else {})}


@dataclasses.dataclass
class RoundResult:
    """One round of the launcher: the exit code the launcher would return,
    and each rank's raw exit status.

    ``resize_to`` is set when the round ended because the CAPACITY PROBE
    asked for it (a grow when cards came back, a shrink when the fleet
    scheduler gave this run's cards away): the round SIGTERMed its world,
    every rank checkpointed and exited 75, and the supervisor relaunches
    with ``--resume`` at that size without touching the restart budget."""

    rc: int
    rank_exits: Dict[int, int]
    resize_to: Optional[int] = None

    def survivors(self) -> int:
        return sum(1 for code in self.rank_exits.values() if code in SURVIVOR_EXITS)

    def lost(self) -> int:
        return len(self.rank_exits) - self.survivors()


def feasible_sizes(original: int) -> list:
    """The world sizes a run may take, largest first: the divisors of its
    original size."""
    return [n for n in range(original, 0, -1) if original % n == 0]


def next_world_size(original: int, survivors: int, min_procs: int) -> Optional[int]:
    """The largest feasible size the survivors can staff, at least
    ``min_procs``; None when there is none (the run fails rather than go
    on below its floor)."""
    for n in feasible_sizes(original):
        if n <= survivors and n >= max(1, min_procs):
            return n
    return None


def grow_target(original: int, current: int, available: int, max_procs: int = 0) -> Optional[int]:
    """The largest feasible size that ``available`` staffs, strictly above
    ``current`` and at most ``max_procs`` (0: the original size; a run
    never grows past what it asked for); None when the capacity does not
    reach the next divisor up."""
    bound = min(max_procs, original) if max_procs > 0 else original
    for n in feasible_sizes(original):
        if current < n <= min(available, bound):
            return n
    return None


def shrink_target(original: int, current: int, available: int, min_procs: int) -> Optional[int]:
    """The largest feasible size at most ``available``, strictly below
    ``current`` and at least the floor: a donation's size. None when there
    is none (the run keeps its cards: a donation never does what a
    preemption could not)."""
    for n in feasible_sizes(original):
        if n < current and n <= available and n >= max(1, min_procs):
            return n
    return None


class CapacityProbe:
    """The deterministic capacity probe.

    ``census`` says how many processes' worth of cards the run may use
    now (the launcher backs it with ``fleet/capacity.py``: the allocation
    file, the environment, or the original size). :meth:`poll`, called
    from the running round's wait loop, returns a resize target (a GROW
    when the census staffs a larger divisor, a SHRINK when it fell below
    the current size) or None.

    Probes fire every ``interval`` on the injectable ``clock`` (tests pass
    ``now``), and each grow arms the ``resilience/retry.py`` cooldown
    (``cooldown_base * 2**k``, at most ``cooldown_max``) before the next,
    so a census that flaps cannot thrash the run through checkpoints and
    relaunches. Shrinks are not cooled down: the cards are already gone.
    """

    def __init__(
        self,
        census: Callable[[], Optional[int]],
        *,
        original: int,
        min_procs: int = 1,
        max_procs: int = 0,
        interval: float = 30.0,
        cooldown_base: Optional[float] = None,
        cooldown_max: float = 600.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if original <= 0:
            raise ValueError(f"original world size must be positive, got {original}")
        if interval <= 0:
            raise ValueError(f"probe interval must be positive, got {interval}")
        self.census = census
        self.original = int(original)
        self.min_procs = int(min_procs)
        self.max_procs = int(max_procs)
        self.interval = float(interval)
        self.cooldown_base = (float(cooldown_base) if cooldown_base is not None
                              else 2.0 * self.interval)
        self.cooldown_max = float(cooldown_max)
        self.clock = clock
        self.grows = 0  # grows issued in the current cycle: the cooldown's index
        self._next_probe: Optional[float] = None  # the first poll arms it
        self._grow_cooldown_until = float("-inf")  # grows only

    def available(self) -> Optional[int]:
        """One census read, unpaced: the supervisor caps a failure
        relaunch with it. None: the census cannot answer (unconstrained)."""
        try:
            avail = self.census()
        except OSError:
            return None  # an unreadable census never kills the policy
        return int(avail) if avail is not None else None

    def poll(self, current: int, now: Optional[float] = None) -> Optional[int]:
        """Read the census at the probe's pace; returns the resize target
        or None. The first call only arms the timer: a fresh round gets a
        whole interval before any reading can move it again."""
        now = self.clock() if now is None else now
        if self._next_probe is None:
            self._next_probe = now + self.interval
            return None
        if now < self._next_probe:
            return None
        self._next_probe = now + self.interval
        avail = self.available()
        if avail is None:
            return None
        if avail < current:
            # a shrink ends the cycle: the next cycle's grows start the
            # cooldown ladder from its base again (the cooldown the last
            # grow armed still stands, so a flapping census is paced)
            self.grows = 0
            return shrink_target(self.original, current, avail, self.min_procs)
        if now < self._grow_cooldown_until:
            return None
        target = grow_target(self.original, current, avail, self.max_procs)
        if target is None:
            return None
        # the k-th grow waits the k-th retry.py delay before the next may fire
        self.grows += 1
        self._grow_cooldown_until = now + backoff_delays(
            self.grows, self.cooldown_base, self.cooldown_max)[self.grows - 1]
        return target

    def reset_timer(self, now: Optional[float] = None) -> None:
        """Re-arm the interval from ``now``: the launcher calls it when a
        round spawns, so the new world gets a whole interval (the grow
        cooldown is separate and stays)."""
        now = self.clock() if now is None else now
        self._next_probe = max(self._next_probe or 0.0, now + self.interval)


def supervise(
    run_round: Callable[[int, int], RoundResult],
    *,
    nproc: int,
    min_procs: int,
    max_restarts: int,
    backoff_base: float = 0.5,
    backoff_max: float = 30.0,
    sleep: Optional[Callable[[float], None]] = None,
    announce: Optional[Callable[[str], None]] = None,
    should_continue: Optional[Callable[[], bool]] = None,
    probe: Optional[CapacityProbe] = None,
    same_size_retries: int = 2,
    start_procs: Optional[int] = None,
) -> int:
    """Run ``run_round(world_size, round_index)`` until the run completes,
    the restart budget is spent, or the world would fall below its floor.
    Returns the last round's exit code (0 on success).

    ``should_continue`` is asked before every relaunch, the stop request
    checked before the backoff and again after it: the launcher passes
    "I was not SIGTERMed myself". When the orchestrator stops the whole
    job, the supervisor surfaces the requeue code instead of relaunching
    against it; that outranks every other branch, resizes included.

    ``probe`` arms the resize half: a round that ends with ``resize_to``
    set is relaunched at that size at once, with no backoff and no charge
    to the budget (grows climb the divisor chain and the probe paces
    them). On a FAILURE relaunch the census also caps the survivors' size:
    exit codes say who died, the census says whose cards still exist.

    ``start_procs`` launches the FIRST round at a smaller feasible size
    (the launcher passes the size the census grants at start); every size
    is still derived from the original ``nproc``, so the run grows back
    when the cards return.

    ``same_size_retries`` bounds the retries after a preemption of the
    whole world: at most that many in a row at the same size, then one
    divisor down (floor permitting), rather than spending the whole budget
    on capacity that is not coming back."""
    do_sleep = sleep if sleep is not None else time.sleep
    say = announce if announce is not None else (lambda _msg: None)
    keep_going = should_continue if should_continue is not None else (lambda: True)
    delays = backoff_delays(max(1, max_restarts), backoff_base, backoff_max)
    n = start_procs if start_procs is not None else nproc
    round_idx = 0
    restarts_used = 0
    same_size_used = 0
    res = run_round(n, round_idx)
    while True:
        if res.rc == 0:
            return 0
        if not keep_going():
            say("elastic: the launcher itself was asked to stop — "
                f"surfacing exit {res.rc} instead of relaunching")
            return res.rc
        if res.resize_to is not None and res.resize_to != n:
            # a voluntary resize: the round checkpointed and stood its
            # world down; relaunch now, no backoff, no charge
            target = res.resize_to
            say("elastic: "
                + ("capacity returned — growing" if target > n else "chips donated — shrinking")
                + f" from world size {n} to {target} (round {round_idx + 1}, restart budget "
                f"untouched at {restarts_used}/{max_restarts})")
            same_size_used = 0
            n = target
            round_idx += 1
            res = run_round(n, round_idx)
            continue
        if restarts_used >= max_restarts:
            say(f"elastic: restart budget ({max_restarts}) spent; surfacing exit {res.rc}")
            return res.rc
        lost = res.lost()
        survivors = res.survivors()
        if lost == 0:
            # every rank can be rescheduled: retry at the same size, at
            # most same_size_retries times in a row, then one divisor down
            if same_size_used < same_size_retries:
                same_size_used += 1
                target = n
            else:
                smaller = [s for s in feasible_sizes(nproc) if s < n and s >= max(1, min_procs)]
                if smaller:
                    target = smaller[0]
                    say(f"elastic: {same_size_used} same-size retries at world size {n} all "
                        f"lost the whole pod — stepping down to {target}")
                    same_size_used = 0
                else:
                    target = n  # at the floor already: keep trying
        else:
            same_size_used = 0
            target = next_world_size(nproc, survivors, min_procs)
            if target is None:
                say(f"elastic: only {survivors} of {n} rank(s) survived — no feasible world "
                    f"size >= min_procs={min_procs}; giving up with exit {res.rc}")
                return res.rc
        if probe is not None:
            # the census caps a failure relaunch
            avail = probe.available()
            if avail is not None and avail < target:
                capped = next_world_size(nproc, int(avail), min_procs)
                if capped is None:
                    say(f"elastic: capacity census reports {avail} proc(s) available — no "
                        f"feasible world size >= min_procs={min_procs}; giving up with exit "
                        f"{res.rc}")
                    return res.rc
                if capped != target:
                    say(f"elastic: capacity census caps the relaunch at {capped} (survivors "
                        f"allowed {target}, census reports {avail} available)")
                    target = capped
        if target != n:
            same_size_used = 0  # a new size starts a fresh same-size streak
        delay = delays[min(restarts_used, len(delays) - 1)]
        say(f"elastic: relaunching at world size {target} (was {n}, {lost} rank(s) lost; "
            f"restart {restarts_used + 1}/{max_restarts}, backoff {delay:g}s)")
        do_sleep(delay)
        if not keep_going():
            # the stop can land during the backoff: no new world after it
            say(f"elastic: stop requested during backoff — surfacing exit {res.rc} instead "
                "of relaunching")
            return res.rc
        restarts_used += 1
        round_idx += 1
        n = target
        res = run_round(n, round_idx)
