"""The tenancy drill, ``python -m tpu_dist_torch.fleet.tenancy_drill``: the
port's counterpart of ``tpu_dist/fleet/tenancy_drill.py``, the proof of
train and serve co-scheduling. One recorded diurnal day (off-peak, a load
spike, the recovery, off-peak again) is replayed through the kind-aware
:class:`~tpu_dist_torch.fleet.scheduler.FleetScheduler`:

**Phase policy**: the replay on a manual tick clock. Every tick writes the
recorded serving window (real ``ServeStats`` through the real SLO alert
engine, whose ``slo_*`` rules fire on the spike), scrapes it back through
one :class:`~tpu_dist_torch.obs.hub.TelemetryHub` pass fed to
``signals_from_hub``, and steps the scheduler. Held exactly: the
preempting donation at ``spike_tick + serve_breach_ticks - 1`` (@3), its
cards granted one tick later (@4) under the same ``decision_id``, the
serving availability recovered, the off-peak release (@8) and the
trainer's grow back (@9), the federated page's per-run labels and
``pod.last_decision_id``, and the chip-second audit over the per-tick
``tenancy`` records (integer chip-ticks, no slack).

**Phase cycle**: the same day against a real trainer. A golden,
uninterrupted run first; then the co-scheduled run under the real
``elastic/supervisor.py`` loop and a capacity probe over the scheduler's
allocation file. The spike preempts the trainer (the allocation shrinks,
the probe SIGTERMs the round, the emergency snapshot, exit 75, the
relaunch at ``--shrink_to``), the serving run gets the cards, it recovers,
and off-peak the scheduler's release and grant give the cards back (the
allocation grows, the probe, the snapshot, the relaunch at full size).
Held: a shrink and a grow ``resume`` record, every epoch's loss within
:data:`LOSS_RTOL` of the golden run's, the recovered availability, the
preemption's latency (the donation, the probe's SIGTERM, exit 75), the
chip-second audit, and the causal chain: the preempting donation's
``decision_id`` in the scheduler's ``fleet`` records, in the allocation
file's tokens (stamped into the relaunch's environment), in the shrunken
trainer's ``resume`` record with ``decision_cause == "serve_breach"``, in
its flight ring, and in ``pod.last_decision_id`` on the hub's page; the
relaunch gap charged to the goodput ledger's ``preempt_for_serve_s`` with
the buckets still summing to the wall clock.

A world of ``n`` is ``python -m tpu_dist_torch.cli.launch --nproc n``
over the trainer's CLI, as in ``fleet/drill.py``: CPU gloo ranks with
``--device cpu``, cards with ``--device cuda`` (the default), and
``--shrink_device`` for the shrunken round (on a one-card machine the
full-size rounds run as CPU ranks and the shrunken round on the card). A
world larger than the cards there are fails, naming the count. Each rank
runs ``cli.train``'s ``main`` in a child that appends its kernel launch
counts to ``<workdir>/launches.jsonl`` at its exit, which the drill reports
a round. Two differences from the JAX drill, both for the same reason (a
port world is processes whose crops are keyed by rank, so an epoch begun at
another process count draws other crops: ROADMAP Queue C): the preemption
lands in a known epoch (round 0 holds at step ``--kill_step`` of
``--kill_epoch``, a bounded ``hang@`` that the probe's SIGTERM ends), and
the shrunken round holds after the last step of that epoch, read from its
flight ring, so the cards come back at the epoch's end and the grown world
closes the epoch from its snapshot. The serving run's off-peak size is
half its peak, as in JAX, with its peak at least 2 and a vacancy of one
card less than the spike needs (JAX's pod at its defaults; at
``--shrink_to 1``, where JAX's pod has no feasible serving size, a pod of
``--devices`` + 1 cards).

**Phase replica**: a supervised serving replica
(``python -m tpu_dist_torch.serve replica``, from a checkpoint the port's
writer makes of the JAX drill's model, or of ViT-B/16 with
``--replica_model vit_b16``) is SIGKILLed while it serves; the
:class:`~tpu_dist_torch.serve.supervisor.ReplicaSupervisor` sees the
crash, bundles the evidence before it relaunches, and the relaunch
restores the same weights (equal digests), serves (a window of completed
requests in its history) with no retrace, and drains on SIGTERM. The
drained replica's flash launches are reported.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

from tpu_dist_torch.elastic.supervisor import (CapacityProbe, RoundResult, stamp_decision_env,
                                               supervise)
from tpu_dist_torch.fleet import capacity as capacity_lib
from tpu_dist_torch.fleet.drill import (HOLD_LIMIT_S, LOSS_RTOL, _check_world, _epoch_losses,
                                        _load, _world_env)
from tpu_dist_torch.fleet.scheduler import (FleetPolicy, FleetScheduler, RunSpec,
                                            audit_chip_seconds, signals_from_hub)
from tpu_dist_torch.obs import export as export_lib
from tpu_dist_torch.obs import flight as flight_lib
from tpu_dist_torch.obs import goodput as goodput_lib
from tpu_dist_torch.obs import hub as hub_lib
from tpu_dist_torch.resilience.preemption import PREEMPTION_EXIT_CODE

#: The recorded diurnal day of the policy phase, one profile a scheduler
#: tick. With the default policy (serve_breach_ticks=2,
#: serve_release_ticks=3, move_cooldown=2) the decisions land at: the
#: preempting donation @3, its grant @4, the off-peak release @8, the
#: trainer's grow back @9.
DIURNAL_TRACE = (
    "idle",        # 1: off-peak, the trainer soaks the pod
    "spike",       # 2: the load spike (the queue grows, slo_* fire)
    "spike",       # 3: sustained: the breach streak reaches serve_breach_ticks
    "spike",       # 4: the pending cards mature and land
    "recovering",  # 5: latency back under the SLO, the backlog draining
    "idle",        # 6: healthy reading 1
    "idle",        # 7: healthy reading 2
    "idle",        # 8: healthy reading 3: the off-peak release
    "idle",        # 9: the released cards mature: the trainer grows back
    "idle",        # 10: steady again
)
SPIKE_TICK = 1 + DIURNAL_TRACE.index("spike")  # ticks count from 1

#: One tick in seconds: the policy phase's manual clock, and the
#: chip-second unit of the audit.
TICK_SECONDS = 1.0

#: The drill's trainer child: ``cli.train``'s main, then this rank's kernel
#: launch counts appended to the file ``$TENANCY_LAUNCHES`` names, tagged
#: with the world's ``$TENANCY_ROUND``.
_TRAIN_CHILD = """
import json, os, sys
from tpu_dist_torch.cli import train
from tpu_dist_torch.ops import flash_attention, fused_sgd
rc = 1
try:
    train.main()
    rc = 0
except SystemExit as e:
    rc = e.code if isinstance(e.code, int) else 1
    raise
finally:
    with open(os.environ["TENANCY_LAUNCHES"], "a") as f:
        f.write(json.dumps({
            "round": os.environ["TENANCY_ROUND"],
            "rank": int(sys.argv[sys.argv.index("--process_id") + 1]),
            "device": sys.argv[sys.argv.index("--device") + 1], "rc": rc,
            "fused_sgd": fused_sgd.fused_sgd.launches,
            "flash_attention_fwd": flash_attention.flash_fwd.launches}) + "\\n")
"""

#: The replica phase's checkpoint: the port's writer of the JAX drill's
#: model (or ViT-B/16), a ZeRO-1 run's checkpoint at dp 4.
_MAKE_CKPT = """
import sys
from tpu_dist_torch.serve.drill import _drill_model, write_training_ckpt
if sys.argv[2] == "vit_b16":
    from tpu_dist_torch.nn.vit import vit_b16
    model = vit_b16(device="cpu")
else:
    model = _drill_model("cpu")
write_training_ckpt(sys.argv[1], model)
"""


def _say(msg: str) -> None:
    # tpu-dist: ignore[TD007] — single-process CLI; stdout is the report
    print(f"tenancy-drill: {msg}", flush=True)


def _pod_scheduler(fleet_dir: Optional[str], devices: int, shrink_to: int) -> FleetScheduler:
    """The drill's pod: a trainer on ``devices`` cards, a serving run at its
    off-peak size (half its peak), and the vacancy: 11 cards at the
    defaults, JAX's pod. Both phases use the same shape, so the policy
    phase's tick arithmetic carries over to the cycle."""
    peak = max(shrink_to, 2)
    off_peak = peak // 2
    vacant = peak - off_peak - 1  # one card short of the spike's need: it must preempt
    return FleetScheduler(
        [RunSpec("trainer", devices, min_procs=shrink_to, kind="train"),
         RunSpec("svc", peak, min_procs=1, kind="serve")],
        policy=FleetPolicy(), fleet_dir=fleet_dir,
        allocations={"trainer": devices, "svc": off_peak},
        total_chips=devices + off_peak + vacant)


# -- the recorded serving windows ---------------------------------------------------


def _serve_window_stats(profile: str, k: int = 0):
    """One recorded serving window. ``spike`` breaks the 500 ms p99 ceiling
    and the 50 ms deadline, its queue growing tick over tick (``k``, the
    spike's tick index); ``recovering`` is under every ceiling with a
    backlog still draining (not yet a release); ``idle`` is off-peak."""
    from tpu_dist_torch.serve import slo as slo_lib  # noqa: PLC0415

    stats = slo_lib.ServeStats(deadline_s=0.05)
    if profile == "spike":
        for _ in range(4):
            stats.on_batch(3, 4)
            stats.on_request_done(0.6, 0.45, {p: 0.1 for p in slo_lib.PHASES})
        stats.set_queue_depth(4 + 3 * k)
    elif profile == "recovering":
        for _ in range(4):
            stats.on_batch(4, 4)
            stats.on_request_done(0.02, 0.01, {p: 0.004 for p in slo_lib.PHASES})
        stats.set_queue_depth(2)
    else:  # idle
        for _ in range(2):
            stats.on_batch(1, 1)
            stats.on_request_done(0.02, 0.01, {p: 0.004 for p in slo_lib.PHASES})
        stats.set_queue_depth(0)
    return stats


def _write_atomic(path: str, text: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _write_serve_exposition(path: str, engine, profile: str, k: int) -> dict:
    """Render one recorded window through the persistent SLO alert engine
    (what a replica's exporter publishes: the ``slo_*`` rules fire on the
    spike and clear after it) and write it atomically. Returns the
    window's scalars."""
    stats = _serve_window_stats(profile, k)
    window = stats.scalars(window_s=1.0, completed_in_window=stats.completed)
    engine.observe(window)
    _write_atomic(path, export_lib.render(window, {"alert_active": engine.active()},
                                          histograms=stats.histogram_families()))
    return window


def _write_trainer_exposition(path: str, stall: float = 0.02) -> None:
    _write_atomic(path, export_lib.render({
        "train.data_stall_frac": stall, "goodput.goodput_frac": 0.93, "train.mfu": 0.52,
        "train.epoch": 1}))


def _pod_hub(fleet_dir: str):
    """The recorded trainer exposition and the hub over it and the serving
    run's: the one scrape fan-in the arbiter reads."""
    svc_prom = os.path.join(fleet_dir, "svc", "metrics.prom")
    trainer_prom = os.path.join(fleet_dir, "trainer", "metrics.prom")
    fleet_prom = os.path.join(fleet_dir, "fleet.prom")
    os.makedirs(os.path.dirname(svc_prom), exist_ok=True)
    os.makedirs(os.path.dirname(trainer_prom), exist_ok=True)
    _write_trainer_exposition(trainer_prom)
    hub = hub_lib.TelemetryHub(
        [hub_lib.RunSource("trainer", metrics_file=trainer_prom, kind="train"),
         hub_lib.RunSource("svc", metrics_file=svc_prom, kind="serve")],
        fleet_exposition=fleet_prom)
    return hub, svc_prom, fleet_prom


def _report_conservation(records: List[dict]) -> bool:
    audit = audit_chip_seconds(records, tick_s=TICK_SECONDS)
    per_run = ", ".join(f"{run}={cs:g}" for run, cs in audit["per_run"].items())
    _say(f"chip-seconds over {audit['n_ticks']} tick(s) x {audit['total_chips']} chip(s): "
         f"{per_run}, free={audit['free_chip_s']:g}, pending={audit['pending_chip_s']:g} "
         f"-> accounted {audit['accounted_chip_s']:g} of {audit['pod_chip_s']:g} pod "
         "chip-seconds")
    if not audit["conserved"]:
        _say(f"FAIL: chip-second conservation VIOLATED: "
             f"{audit['violations'] or 'totals diverge'}")
        return False
    _say("chip-second conservation identity holds EXACTLY")
    return True


def _failed(checks) -> bool:
    bad = [what for what, passed in checks if not passed]
    for what in bad:
        _say(f"FAIL: {what}")
    return bool(bad)


# -- phase policy ------------------------------------------------------------


def run_policy_phase(args) -> int:
    """The recorded day on the manual tick clock: host arithmetic only, no
    device and no child process, every signal scraped off disk."""
    from tpu_dist_torch.serve import slo as slo_lib  # noqa: PLC0415

    fleet_dir = os.path.join(args.workdir, "policy_fleet")
    sched = _pod_scheduler(fleet_dir, args.devices, args.shrink_to)
    policy = sched.policy
    slo_engine = slo_lib.make_slo_engine(slo_lib.load_slo_rules("default"))
    hub, svc_prom, fleet_prom = _pod_hub(fleet_dir)

    by_tick: dict = {}
    spike_k = 0
    recovered_at: Optional[int] = None
    for tick, profile in enumerate(DIURNAL_TRACE, start=1):
        window = _write_serve_exposition(svc_prom, slo_engine, profile, spike_k)
        if profile == "spike":
            spike_k += 1
        sched.write_exposition(fleet_prom)
        sig = signals_from_hub(hub.collect())
        if sig["svc"].queue_depth != window["serve.queue_depth"]:
            _say(f"FAIL: tick {tick}: the hub's scrape did not round-trip the queue")
            return 1
        for d in sched.step(tick, sig, ts=tick * TICK_SECONDS):
            by_tick[tick] = d
            _say(f"tick {tick}: {d['action']}{' [SLO preemption]' if d.get('preempt') else ''}"
                 f" — {d['reason']}")
        if (recovered_at is None and tick > SPIKE_TICK
                and (sig["svc"].availability or 0.0) >= policy.serve_ok_availability):
            recovered_at = tick
            _say(f"tick {tick}: availability {sig['svc'].availability:.1%} — recovered over "
                 f"{policy.serve_ok_availability:.1%}")

    donate_tick = SPIKE_TICK + policy.serve_breach_ticks - 1
    grant_tick = donate_tick + 1
    donate, grant = by_tick.get(donate_tick, {}), by_tick.get(grant_tick, {})
    if _failed((
        ("preempt-donate at the documented bound",
         donate.get("action") == "donate" and donate.get("preempt") is True
         and donate.get("donor") == "trainer"),
        ("preempt-grant one tick later",
         grant.get("action") == "grant" and grant.get("preempt") is True
         and grant.get("recipient") == "svc"),
        ("availability recovered after the chips landed",
         recovered_at is not None and recovered_at > grant_tick),
        ("off-peak release fired",
         any(d.get("action") == "donate" and d.get("donor") == "svc" and not d.get("preempt")
             for d in by_tick.values())),
        ("trainer grew back to its original size", sched.alloc["trainer"] == args.devices),
        ("both preemption moves counted", sched.preemptions == 2),
        ("donate and its completion grant share ONE decision_id",
         donate.get("decision_id") is not None
         and donate.get("decision_id") == grant.get("decision_id")
         and grant.get("chained") is True),
        ("the hub aggregated every tick with zero drops",
         hub.drops_total == {"torn": 0, "dead": 0, "absent": 0}),
    )):
        return 1
    _say(f"preemption latency: SIGTERM'd the trainer at tick {donate_tick} (= spike tick "
         f"{SPIKE_TICK} + serve_breach_ticks {policy.serve_breach_ticks} - 1), chips landed "
         f"at tick {grant_tick}")
    sched.write_exposition(fleet_prom)
    page = hub.federated()
    if not (page.endswith("# EOF\n") and 'run="svc"' in page
            and "tpu_dist_pod_last_decision_id" in page
            and "tpu_dist_pod_runs_aggregated 2" in page):
        _say("FAIL: the federated hub page lost its per-run labels or pod rollups")
        return 1
    _say("hub: federated page carries per-run labels + pod rollups "
         f"(last decision #{sched.last_decision_id})")
    if not _report_conservation(_load(sched.history_path())):
        return 1
    _say("PASS policy: recorded diurnal replay reproduced every arbitration event at its "
         "documented tick")
    return 0


# -- phase cycle -------------------------------------------------------------


class _DiurnalDay:
    """The cycle's signal source: the recorded profiles, paced by the real
    trainer. The spike starts once round 0 holds at its step of the
    preempted epoch (``holding``: on a loaded host, a spike timed by an
    earlier record can preempt the round before it gets there) and holds
    until the serving run has its cards (the breach must last through the
    donor's vacating); the recovery holds until the shrunken trainer has
    resumed and reached the end of the preempted epoch
    (``shrunken_done``); then the day is off-peak (the reclaim)."""

    def __init__(self, sched: FleetScheduler, holding: Callable[[], bool],
                 shrunken_done: Callable[[], bool]):
        from tpu_dist_torch.serve import slo as slo_lib  # noqa: PLC0415

        self.sched = sched
        self.holding = holding
        self.shrunken_done = shrunken_done
        self.tick = 0
        self.spike_k = 0
        self.spike_tick: Optional[int] = None
        self.donate_tick: Optional[int] = None
        self.donated_at_s: Optional[float] = None
        self.grant_tick: Optional[int] = None
        self.recovered = False
        self.decisions: List[dict] = []
        self.slo_engine = slo_lib.make_slo_engine(slo_lib.load_slo_rules("default"))
        self.hub, self.svc_prom, self.fleet_prom = _pod_hub(sched.fleet_dir)

    def profile(self) -> str:
        if self.grant_tick is None:
            # before the grant: off-peak until round 0 holds, then the
            # spike, held until the cards land
            if self.spike_tick is None and not self.holding():
                return "idle"
            return "spike"
        if self.sched.alloc["svc"] == self.sched.specs["svc"].original:
            return "idle" if self.shrunken_done() else "recovering"
        return "idle"  # reclaimed: the day stays off-peak

    def step(self) -> None:
        self.tick += 1
        profile = self.profile()
        if profile == "spike" and self.spike_tick is None:
            self.spike_tick = self.tick
            _say(f"tick {self.tick}: the recorded load spike begins")
        _write_serve_exposition(self.svc_prom, self.slo_engine, profile, self.spike_k)
        if profile == "spike":
            self.spike_k += 1
        self.sched.write_exposition(self.fleet_prom)
        sig = signals_from_hub(self.hub.collect())
        for d in self.sched.step(self.tick, sig, ts=time.time()):
            self.decisions.append(d)
            _say(f"tick {self.tick}: {d['action']}"
                 f"{' [SLO preemption]' if d.get('preempt') else ''} — {d['reason']}")
            if d.get("preempt") and d["action"] == "donate":
                self.donate_tick = self.tick
                self.donated_at_s = time.monotonic()
            if d.get("preempt") and d["action"] == "grant":
                self.grant_tick = self.tick
        if (self.grant_tick is not None and not self.recovered
                and (sig["svc"].availability or 0.0)
                >= self.sched.policy.serve_ok_availability):
            self.recovered = True
            _say(f"tick {self.tick}: serving availability {sig['svc'].availability:.1%} — "
                 "recovered")


def _world_cmd(n: int, device: str, train_args: List[str], restarts: int,
               decision: dict, tag: str) -> List[str]:
    """A world of ``n`` ranks over the drill's trainer child; the drill owns
    the restart count and the fleet decision's tokens (``env`` sets them in
    each rank over the one-round launcher's own stamps)."""
    tokens = [f"{k}={v}" for k, v in sorted(decision.items())]
    return [sys.executable, "-m", "tpu_dist_torch.cli.launch", "--nproc", str(n), "--",
            "env", f"TPU_DIST_ELASTIC_RESTARTS={restarts}", f"TENANCY_ROUND={tag}", *tokens,
            sys.executable, "-c", _TRAIN_CHILD, *train_args, "--device", device]


def _round_launches(path: str) -> dict:
    """``{world's tag: {kernel: launches summed over its ranks}}``."""
    out: dict = {}
    for rec in _load(path):
        got = out.setdefault(rec["round"], {"fused_sgd": 0, "flash_attention_fwd": 0,
                                               "device": rec["device"], "ranks": 0})
        got["fused_sgd"] += rec["fused_sgd"]
        got["flash_attention_fwd"] += rec["flash_attention_fwd"]
        got["ranks"] += 1
    return out


def run_cycle_phase(args) -> int:
    shrink_device = args.shrink_device or args.device
    for n, device in ((args.devices, args.device), (args.shrink_to, shrink_device)):
        why = _check_world(n, device)
        if why:
            _say(f"FAIL: {why}")
            return 1
    golden_log = os.path.join(args.workdir, "golden.jsonl")
    elastic_log = os.path.join(args.workdir, "elastic.jsonl")
    launches_file = os.path.join(args.workdir, "launches.jsonl")
    last_step = args.steps_per_epoch - 1
    base = [
        "--dataset", "synthetic", "--model", args.model,
        "--num_classes", "10", "--synthetic_n", "256",
        "--batch_size", str(args.batch_size),
        "--epochs", str(args.epochs),
        "--steps_per_epoch", str(args.steps_per_epoch),
        "--eval_every", "0", "--save_every", "1", "--log_every", "50",
        "--seed", "0", "--shard_weight_update",
    ] + (["--fused_optimizer"] if args.fused_optimizer else [])

    def env_for(device: str) -> dict:
        return dict(_world_env(device), TENANCY_LAUNCHES=launches_file)

    _say(f"phase golden: {args.devices} rank(s) on {args.device}, uninterrupted")
    t0 = time.monotonic()
    rc = subprocess.call(
        _world_cmd(args.devices, args.device,
                   base + ["--ckpt_dir", os.path.join(args.workdir, "ck_golden"),
                           "--log_file", golden_log], 0, {}, "golden"),
        env=env_for(args.device))
    if rc != 0:
        _say(f"FAIL: golden run exited {rc}")
        return 1
    _say(f"phase golden: exit 0 in {time.monotonic() - t0:.1f} s")

    fleet_dir = os.path.join(args.workdir, "cycle_fleet")
    sched = _pod_scheduler(fleet_dir, args.devices, args.shrink_to)
    crash_base = os.path.join(args.workdir, "crash")
    held = {}  # round index -> the ring of a shrunken round holding at the epoch's end

    def at_step(ring: str, step: int) -> bool:
        """The rank-0 flight ring's last step record is ``step`` of the
        preempted epoch."""
        try:
            last = flight_lib.last_step(flight_lib.decode(ring))
        except OSError:  # not armed yet
            return False
        return bool(last) and (last.get("epoch"), last.get("step")) == (args.kill_epoch, step)

    def holding() -> bool:
        """Round 0 holds at step --kill_step of the preempted epoch."""
        return at_step(os.path.join(crash_base, "round0", flight_lib.RING_NAME), args.kill_step)

    def shrunken_done() -> bool:
        """The shrunken round got to the last step of the preempted epoch."""
        return any(at_step(ring, last_step) for ring in held.values())

    day = _DiurnalDay(sched, holding, shrunken_done)
    alloc_path = sched.allocation_path("trainer")
    probe = CapacityProbe(capacity_lib.make_census(alloc_path), original=args.devices,
                          min_procs=args.shrink_to, interval=0.3)
    elastic_ck = os.path.join(args.workdir, "ck_elastic")
    latency: dict = {}

    def round_fn(n: int, round_idx: int) -> RoundResult:
        device = shrink_device if n == args.shrink_to else args.device
        crash = os.path.join(crash_base, f"round{round_idx}")
        train = base + ["--ckpt_dir", elastic_ck, "--log_file", elastic_log,
                        "--crash_dir", crash]
        hold = None
        if round_idx == 0:
            # the preemption lands in epoch --kill_epoch: the round holds at
            # its step --kill_step until the probe's SIGTERM ends the hold
            hold = args.kill_step
        else:
            train += ["--resume"]
            if n == args.shrink_to:
                hold = last_step  # the cards come back at the epoch's end
                held[round_idx] = os.path.join(crash, flight_lib.RING_NAME)
        if hold is not None:
            train += ["--fault_plan", f"hang@epoch={args.kill_epoch}:step={hold}:"
                                      f"seconds={HOLD_LIMIT_S:g}"]
        # the decision this relaunch carries out, from the allocation file:
        # the trainer stamps it into its resume record and flight ring
        decision: dict = {}
        meta = stamp_decision_env(decision, alloc_path)
        if round_idx and meta["decision_id"] is not None:
            _say(f"round {round_idx}: relaunch actuates fleet decision #{meta['decision_id']} "
                 f"({meta['cause']})")
        _say(f"round {round_idx}: trainer at {n} rank(s) on {device}")
        proc = subprocess.Popen(_world_cmd(n, device, train, round_idx, decision,
                                           f"round {round_idx}"),
                                env=env_for(device))
        probe.reset_timer()
        resize: Optional[int] = None
        sigterm_at: Optional[float] = None
        last_tick = time.monotonic()
        while proc.poll() is None:
            time.sleep(0.1)
            if time.monotonic() - last_tick >= args.tick_s:
                last_tick = time.monotonic()
                day.step()
            if resize is None:
                target = probe.poll(n)
                if target is not None and target != n:
                    _say(f"probe: census wants {target} (running {n}) — checkpointing this "
                         "round for the resize")
                    resize = target
                    sigterm_at = time.monotonic()
                    proc.send_signal(signal.SIGTERM)  # the launcher forwards it
        rc = proc.returncode
        _say(f"round {round_idx}: exit {rc}")
        if (rc == PREEMPTION_EXIT_CODE and resize is not None and resize < n
                and not latency and day.donated_at_s is not None):
            now = time.monotonic()
            latency.update(total=now - day.donated_at_s,
                           to_sigterm=sigterm_at - day.donated_at_s,
                           sigterm_to_exit=now - sigterm_at)
        return RoundResult(rc, {0: rc}, resize)

    rc = supervise(round_fn, nproc=args.devices, min_procs=args.shrink_to, max_restarts=4,
                   backoff_base=0.01, announce=lambda m: _say(f"supervisor: {m}"), probe=probe)
    if rc != 0:
        _say(f"FAIL: supervised co-scheduled run exited {rc}")
        return 1

    recs = _load(elastic_log)
    resumes = [r for r in recs if r.get("kind") == "resume"]
    shrinks = [r for r in resumes
               if r.get("prev_dp") == args.devices and r.get("dp") == args.shrink_to]
    grows = [r for r in resumes
             if r.get("prev_dp") == args.shrink_to and r.get("dp") == args.devices]
    policy = sched.policy
    if _failed((
        ("a preempt-shrink resume record", bool(shrinks)),
        ("an off-peak grow resume record", bool(grows)),
        ("the preempt-donate decision fired",
         day.donate_tick is not None and day.spike_tick is not None),
        ("the serve run got its chips one tick later",
         day.grant_tick == (day.donate_tick or 0) + 1),
        ("SIGTERM within the tick bound",
         day.donate_tick is not None
         and day.donate_tick - day.spike_tick + 1 == policy.serve_breach_ticks),
        ("serving availability recovered", day.recovered),
        ("trainer back at full size", sched.alloc["trainer"] == args.devices),
        ("preemption wall latency measured", bool(latency) and latency["total"] < 60.0),
    )):
        return 1
    keys = ("epoch", "world", "dp", "prev_dp", "resharded", "mid_epoch_step",
            "examples_offset", "restarts", "decision_id", "decision_cause")
    for tag, rec in (("shrink", shrinks[0]), ("grow", grows[0])):
        _say(f"resume record ({tag}): {json.dumps({k: rec.get(k) for k in keys})}")
    _say(f"preemption latency: donate at tick {day.donate_tick} (spike at "
         f"{day.spike_tick}, bound serve_breach_ticks={policy.serve_breach_ticks}); "
         f"allocation shrink -> SIGTERM {latency['to_sigterm']:.3f} s, SIGTERM -> exit-75 "
         f"{latency['sigterm_to_exit']:.3f} s, in all {latency['total']:.3f}s of wall clock")
    for tag, got in _round_launches(launches_file).items():
        _say(f"launches: {tag}: {got['ranks']} rank(s) on {got['device']}: fused_sgd "
             f"{got['fused_sgd']}, flash_attention_fwd {got['flash_attention_fwd']}")
    golden = _epoch_losses(_load(golden_log))
    elastic = _epoch_losses(recs)
    for epoch, want in sorted(golden.items()):
        got = elastic.get(epoch)
        if got is None:
            _say(f"FAIL: co-scheduled run has no epoch {epoch}")
            return 1
        rel = abs(got - want) / max(abs(want), 1e-12)
        _say(f"epoch {epoch}: golden loss {want:.6f}, co-scheduled {got:.6f} (rel {rel:.2e})")
        if rel > LOSS_RTOL:
            _say(f"FAIL: loss diverged past rtol {LOSS_RTOL}")
            return 1
    if not _report_conservation(_load(sched.history_path())):
        return 1

    # the causal chain: one decision_id from the scheduler's records through
    # the allocation file and the relaunch env to the resume record, the
    # shrunken round's flight ring and the hub's page; the goodput ledger
    # charges the serve-preempt gap to its own bucket, the partition exact
    donates = [d for d in day.decisions if d.get("preempt") and d["action"] == "donate"]
    did = donates[0].get("decision_id") if donates else None
    ledger_ids = {r.get("decision_id") for r in _load(sched.history_path())
                  if r.get("kind") == "fleet"}
    shrink = shrinks[0]
    ring_resumes: List[dict] = []
    try:
        ring = flight_lib.decode(os.path.join(crash_base, f"round{shrink.get('restarts')}",
                                              flight_lib.RING_NAME))
        ring_resumes = [r for r in ring["records"]
                        if r.get("kind") == "resume" and r.get("decision_id") == did]
    except OSError as e:
        # the ring check below fails on an empty ring_resumes, naming the link
        _say(f"note: donor flight ring unreadable ({e!r})")
    sched.write_exposition(day.fleet_prom)
    rollup = day.hub.collect()["rollup"]
    gp = goodput_lib.run_ledger(recs) or {}
    bucket_sum = sum(gp.get(f"{b}_s", 0.0) for b in goodput_lib.ALL_BUCKETS)
    if _failed((
        ("the preempt-donate carried a decision_id", isinstance(did, int)),
        ("the scheduler ledger stamped it", did in ledger_ids),
        ("the shrink resume record propagated it",
         shrink.get("decision_id") == did and shrink.get("decision_cause") == "serve_breach"),
        ("the donor's flight ring stamped it", bool(ring_resumes)),
        ("the hub exposition rolled it up",
         isinstance(rollup.get("last_decision_id"), float)
         and rollup["last_decision_id"] >= (did or 1)),
        ("the serve-preempt gap landed in preempt_for_serve_s",
         gp.get("preempt_for_serve_s", 0.0) > 0.0),
        # run_ledger rounds each of the 10 terms to 4 decimals: the rounded
        # sum can drift from the rounded elapsed by at most 5e-4
        ("the goodput bucket partition stayed exact",
         abs(bucket_sum - gp.get("elapsed_s", -1.0)) < 1e-3),
    )):
        return 1
    _say("goodput: " + goodput_lib.ledger_line(gp) + "; buckets "
         + json.dumps({b: gp[f"{b}_s"] for b in goodput_lib.ALL_BUCKETS}))
    _say(f"causal chain: decision #{did} spans scheduler ledger -> relaunch env -> resume "
         "record -> donor flight ring -> hub exposition; "
         f"preempt_for_serve_s={gp['preempt_for_serve_s']:.1f}s with the bucket partition "
         "exact")
    _say("PASS cycle: spike preempted the trainer losslessly, serving recovered, off-peak "
         "reclaimed the chips, books balanced")
    return 0


# -- phase replica -----------------------------------------------------------


def run_replica_phase(args, timeout_s: float = 240.0) -> int:
    """SIGKILL a supervised serving replica; prove the crash, the bundle, the
    relaunch, the same weights and the drain."""
    from tpu_dist_torch.serve.supervisor import ReplicaPolicy, ReplicaSupervisor  # noqa: PLC0415

    why = _check_world(1, args.device)
    if why:
        _say(f"FAIL: {why}")
        return 1
    rdir = os.path.join(args.workdir, "replica")
    ckpt_dir = os.path.join(rdir, "ck")
    os.makedirs(rdir, exist_ok=True)
    status = os.path.join(rdir, "status.jsonl")
    env = _world_env(args.device)
    rc = subprocess.call([sys.executable, "-c", _MAKE_CKPT, ckpt_dir, args.replica_model],
                         env=env)
    if rc != 0:
        _say(f"FAIL: checkpoint writer exited {rc}")
        return 1

    def spawn(incarnation: int):
        _say(f"spawning replica incarnation {incarnation}")
        return subprocess.Popen(
            [sys.executable, "-m", "tpu_dist_torch.serve", "replica", "--ckpt", ckpt_dir,
             "--workdir", rdir, "--status_file", status, "--pace_s", "0.02",
             "--device", args.device, "--model", args.replica_model],
            env=env)

    sup = ReplicaSupervisor(spawn, heartbeat_file=os.path.join(rdir, "hb.json"),
                            policy=ReplicaPolicy(max_restarts=2, backoff_base_s=0.01),
                            postmortem_dirs=[rdir])

    def lines(event: str) -> List[dict]:
        return [r for r in _load(status) if r.get("event") == event]

    def wait(what: str, cond, deadline: float) -> bool:
        while time.monotonic() < deadline:
            if cond():
                return True
            time.sleep(0.2)
        _say(f"FAIL: timed out waiting for {what}")
        return False

    deadline = time.monotonic() + timeout_s
    sup.start()
    try:
        if not wait("incarnation 1 ready", lambda: len(lines("ready")) >= 1, deadline):
            return 1
        first = lines("ready")[0]
        _say(f"incarnation 1 ready: digest {first['weights_digest']}, "
             f"{first['warmup_compiles']} warmup compile(s)")
        _say(f"SIGKILL pid {sup.proc.pid} (the crash under test)")
        os.kill(sup.proc.pid, signal.SIGKILL)
        if not wait("the kill to land", lambda: sup.proc.poll() is not None, deadline):
            return 1
        verdict = sup.poll_once()
        if verdict != "crash":
            _say(f"FAIL: supervisor verdict {verdict!r}, wanted 'crash'")
            return 1
        bundles = [e for e in sup.events if e["event"] == "postmortem"]
        if not bundles:
            _say("FAIL: crash was not postmortem-bundled before relaunch")
            return 1
        _say(f"crash detected (rc {sup.last_rc}), bundled: {bundles[-1]['bundle']}")
        if not wait("incarnation 2 ready", lambda: len(lines("ready")) >= 2, deadline):
            return 1
        second = lines("ready")[1]
        if second["weights_digest"] != first["weights_digest"]:
            _say(f"FAIL: relaunch digest {second['weights_digest']} != "
                 f"{first['weights_digest']} — restore not bit-exact")
            return 1
        _say(f"relaunch restored BIT-EXACT weights (digest {second['weights_digest']})")

        def served() -> List[dict]:  # the relaunched incarnation's serving windows
            return [r for r in _load(os.path.join(rdir, "replica.jsonl"))
                    if r.get("kind") == "serve" and not r.get("event")
                    and r.get("ts", 0) >= second["ts"] and r.get("completed")]

        if not wait("the relaunched replica to serve", lambda: bool(served()), deadline):
            return 1
        _say(f"the relaunched replica serves: {served()[0]['completed']} request(s) in its "
             "first window")
        pid = sup.proc.pid
        sup.proc.send_signal(signal.SIGTERM)  # the graceful vacate
        if not wait("the graceful drain", lambda: sup.proc.poll() is not None, deadline):
            return 1
        if sup.poll_once() != "exit" or not sup.done:
            _say(f"FAIL: expected a clean exit, got rc {sup.last_rc}")
            return 1
        drained = lines("drained")
        if not drained or drained[-1].get("retraces") != 0:
            _say("FAIL: post-warmup retraces in the relaunched replica: "
                 f"{drained and drained[-1].get('retraces')}")
            return 1
        counted = [r for r in lines("launches") if r.get("pid") == pid]
        if counted:
            _say(f"replica launches: pid {pid} served {drained[-1].get('served')} request(s) in "
                 f"{counted[-1]['forwards']} forward(s): flash_attention_fwd "
                 f"{counted[-1]['flash']} ({counted[-1]['flash_mma']} on the tensor cores)")
        _say("PASS replica: SIGKILL detected, bundled, relaunched bit-exact, drained with 0 "
             "post-warmup retraces")
        return 0
    finally:
        if sup.proc is not None and sup.proc.poll() is None:
            sup.proc.kill()
            sup.proc.wait()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpu_dist_torch.fleet.tenancy_drill",
                                description="SLO-aware train+serve co-scheduling drill")
    p.add_argument("--workdir", required=True)
    p.add_argument("--devices", type=int, default=8, help="ranks of the trainer at full size")
    p.add_argument("--shrink_to", type=int, default=4,
                   help="ranks of the preempted trainer (and the serving run's peak size)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the golden and full-size ranks, and the replica, run")
    p.add_argument("--shrink_device", choices=("cuda", "cpu"), default=None,
                   help="where the shrunken round's ranks run (default: --device)")
    p.add_argument("--model", default="vit_tiny")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--steps_per_epoch", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--kill_epoch", type=int, default=1,
                   help="cycle phase: the epoch the preemption lands in")
    p.add_argument("--kill_step", type=int, default=1,
                   help="cycle phase: the step of --kill_epoch round 0 holds at")
    p.add_argument("--fused_optimizer", action="store_true",
                   help="cycle phase: the trainers' SGD through the fused CUDA kernel")
    p.add_argument("--tick_s", type=float, default=0.25,
                   help="cycle phase: wall seconds per scheduler tick")
    p.add_argument("--replica_model", choices=("drill", "vit_b16"), default="drill",
                   help="replica phase: the served model (the JAX drill's, or ViT-B/16 with "
                        "the flash attention kernel)")
    p.add_argument(
        "--phase", choices=("all", "policy", "cycle", "replica", "hub"), default="all",
        help="'policy' = the recorded diurnal replay (pure, fast); 'cycle' = the same day "
             "against a real trainer (training subprocesses); 'replica' = SIGKILL a "
             "supervised serving replica; 'hub' = policy + cycle (the hub fan-in and the "
             "full decision_id chain); 'all' = every phase")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if args.phase in ("all", "cycle", "hub"):
        if not 0 <= args.kill_epoch < args.epochs - 1:
            p.error(f"--kill_epoch {args.kill_epoch} must leave an epoch to grow into "
                    f"(--epochs {args.epochs})")
        # a SIGTERM that ends round 0's hold stops a world of several ranks
        # one step later (the step's vote was cast before it): the shrunken
        # world must still have a step of its epoch after that one
        if not 0 <= args.kill_step < args.steps_per_epoch - 2:
            p.error(f"--kill_step {args.kill_step} must leave the shrunken world a step of "
                    f"its epoch after the stop, one step past the hold (--steps_per_epoch "
                    f"{args.steps_per_epoch})")
    os.makedirs(args.workdir, exist_ok=True)
    if args.phase in ("all", "policy", "hub"):
        rc = run_policy_phase(args)
        if rc != 0:
            return rc
    if args.phase in ("all", "cycle", "hub"):
        rc = run_cycle_phase(args)
        if rc != 0:
            return rc
    if args.phase in ("all", "replica"):
        rc = run_replica_phase(args)
        if rc != 0:
            return rc
    _say("PASS: all requested phases")
    return 0


if __name__ == "__main__":
    sys.exit(main())
