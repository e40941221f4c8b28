"""The fleet drill, ``python -m tpu_dist_torch.fleet.drill``: the port's
counterpart of ``tpu_dist/fleet/drill.py``, the proof of the elastic
scale-up and the fleet arbitration. Two phases:

**Phase grow**, the whole elastic round trip, driven by the REAL
supervisor loop (``elastic/supervisor.py::supervise``) and a real
``CapacityProbe`` over a real allocation file:

1. **Golden**: an uninterrupted run of ``--devices`` ranks (ZeRO-1, so
   the optimizer state is laid over the ranks).
2. **Preempt**: round 0, with ``sigterm@epoch=E:step=S`` in its fault
   plan (round 0 only, as the JAX drill), exits 75; the drill marks the
   preempted cards gone (the allocation file says ``--shrink_to``), and
   the supervisor's failure relaunch is CAPPED BY THE CENSUS: the run
   resumes at ``--shrink_to`` ranks, its state re-laid onto the smaller
   world.
3. **Grow**: once the shrunken world has run the last step of epoch E,
   the drill gives the cards back (the file says ``--devices``); the
   probe sees it, the drill SIGTERMs the round (which checkpoints and
   exits 75), and the supervisor relaunches at the full size, which
   closes epoch E from the snapshot and trains the later epochs. The
   shrunken round holds after that last step (a bounded ``hang@`` clause,
   which changes no state and which the resize SIGTERM ends), and the
   drill reads that it got there from the round's flight ring, so the
   cards come back while it holds, however fast its steps are. The JAX
   drill grows after the shrunken world has begun the next epoch; the
   port grows at the epoch's end, because a world of another process
   count draws other crops in an epoch it begins (ROADMAP Queue C), while
   the rest of an interrupted epoch replays the old world's batches.
4. **Verify**: a shrink ``resume`` record (``prev_dp`` ``--devices`` ->
   ``dp`` ``--shrink_to``) and a grow one, the ``elastic.grows`` counter
   in the history, and each epoch's loss within :data:`LOSS_RTOL` of the
   golden run's. Each record says whether the ZeRO-1 state was re-laid
   (``resharded``): it is when the flat state's padding differs between
   the two world sizes (``vit_tiny``'s 107,978 parameters at 3 <-> 1, not
   at 2 <-> 1).

A world of ``n`` is ``python -m tpu_dist_torch.cli.launch --nproc n``
over ``python -m tpu_dist_torch.cli.train`` (the JAX drill's world is one
process with ``n`` emulated devices): the drill's round function SIGTERMs
the launcher, which forwards the signal to its ranks. The ranks are cards
with ``--device cuda`` (the default) or gloo ranks on the CPU with
``--device cpu``, asked for explicitly; ``--shrink_device`` puts the
shrunken round on another device (one card holds one rank, so a drill on
a one-card machine runs the full-size rounds as CPU ranks and the shrunken
round on the card). A world larger than the cards there are fails, naming
the count, and never moves to the CPU.

**Phase fleet**: two REAL supervised launcher runs (stub children that
import nothing) share one pool of cards; the scheduler scrapes each run's
OpenMetrics textfile, decides that the stalled run donates to the
compute-bound one, writes both allocation files, and both launchers act
on it through their capacity probes (the donor: SIGTERM, 75, relaunch
smaller; the recipient: a grow). Verified: the ``fleet`` decision records
with their scraped inputs, and each run's sequence of world sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional, Sequence

from tpu_dist_torch.elastic.supervisor import CapacityProbe, RoundResult, supervise
from tpu_dist_torch.fleet import capacity as capacity_lib
from tpu_dist_torch.fleet.scheduler import FleetPolicy, FleetScheduler, RunSpec, read_signals
from tpu_dist_torch.obs import export as export_lib
from tpu_dist_torch.obs import flight as flight_lib
from tpu_dist_torch.resilience.preemption import PREEMPTION_EXIT_CODE

#: The golden-trajectory tolerance of the elastic drill: a resumed
#: segment reduces over another number of ranks, so only the summation
#: order differs.
LOSS_RTOL = 2e-3

#: The bound of the shrunken round's hold (seconds). The probe's resize
#: SIGTERM ends the hold as soon as it lands; the bound only keeps a drill
#: whose probe never fires from holding for ever.
HOLD_LIMIT_S = 300


def _say(msg: str) -> None:
    # tpu-dist: ignore[TD007] — single-process CLI; stdout is the report
    print(f"fleet-drill: {msg}", flush=True)


def _check_world(n: int, device: str) -> Optional[str]:
    """Why ``n`` ranks cannot run on ``device``, or None."""
    if device == "cpu":
        return None
    import torch  # noqa: PLC0415

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > cards:
        return (f"{n} rank(s) on {device} need {n} card(s), and this machine has {cards}; "
                "pass --device cpu for CPU ranks")
    return None


def _world_cmd(n: int, device: str, train_args: List[str], restarts: int = 0) -> List[str]:
    # the drill owns the restart count: ``env`` sets it in each rank over
    # the one-round launcher's own stamp (0)
    return [sys.executable, "-m", "tpu_dist_torch.cli.launch", "--nproc", str(n), "--",
            "env", f"TPU_DIST_ELASTIC_RESTARTS={restarts}",
            sys.executable, "-m", "tpu_dist_torch.cli.train", *train_args, "--device", device]


def _world_env(device: str) -> dict:
    env = dict(os.environ)
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")  # the ranks share the host's cores
    return env


def _load(path: str) -> List[dict]:
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return []
    out = []
    for line in lines:
        try:
            out.append(json.loads(line))
        except ValueError:  # tpu-dist: ignore[TD006] — a line still being written
            pass
    return out


def _epoch_losses(records: List[dict]) -> dict:
    return {rec.get("epoch"): rec["loss"]  # the last segment wins
            for rec in records
            if rec.get("kind") == "train_epoch" and isinstance(rec.get("loss"), (int, float))}


# -- phase grow --------------------------------------------------------------


def run_grow_phase(args) -> int:
    shrink_device = args.shrink_device or args.device
    for n, device in ((args.devices, args.device), (args.shrink_to, shrink_device)):
        why = _check_world(n, device)
        if why:
            _say(f"FAIL: {why}")
            return 1
    golden_log = os.path.join(args.workdir, "golden.jsonl")
    elastic_log = os.path.join(args.workdir, "elastic.jsonl")
    cap_file = os.path.join(args.workdir, "allocation")
    base = [
        "--dataset", "synthetic", "--model", args.model,
        "--num_classes", "10", "--synthetic_n", "256",
        "--batch_size", str(args.batch_size),
        "--epochs", str(args.epochs),
        "--steps_per_epoch", str(args.steps_per_epoch),
        "--eval_every", "0", "--save_every", "1", "--log_every", "50",
        "--seed", "0", "--shard_weight_update",
    ]

    _say(f"phase golden: {args.devices} rank(s) on {args.device}, uninterrupted")
    rc = subprocess.call(
        _world_cmd(args.devices, args.device,
                   base + ["--ckpt_dir", os.path.join(args.workdir, "ck_golden"),
                           "--log_file", golden_log]),
        env=_world_env(args.device))
    if rc != 0:
        _say(f"FAIL: golden run exited {rc}")
        return 1

    # the elastic run, under the REAL supervisor and capacity probe: the
    # allocation starts at full capacity, the preemption takes cards
    # away, and the shrunken world's last step of the epoch brings them back
    capacity_lib.write_allocation(cap_file, args.devices)
    probe = CapacityProbe(capacity_lib.make_census(cap_file), original=args.devices,
                          min_procs=args.shrink_to, interval=0.3)
    elastic_ck = os.path.join(args.workdir, "ck_elastic")
    capacity_returned = [False]
    last_step = args.steps_per_epoch - 1

    def at_the_hold(ring: str) -> bool:
        try:
            step = flight_lib.last_step(flight_lib.decode(ring))
        except OSError:  # not armed yet
            return False
        return bool(step) and (step.get("epoch"), step.get("step")) == (args.kill_epoch,
                                                                         last_step)

    def round_fn(n: int, round_idx: int) -> RoundResult:
        device = shrink_device if n == args.shrink_to else args.device
        train = base + ["--ckpt_dir", elastic_ck, "--log_file", elastic_log]
        ring = None
        if round_idx == 0:
            train += ["--fault_plan", f"sigterm@epoch={args.kill_epoch}:step={args.kill_step}"]
        else:
            train += ["--resume"]
            if n == args.shrink_to and not capacity_returned[0]:
                # hold the shrunken world after its last step of the
                # preempted epoch while the cards come back; its flight
                # ring says when it got there
                crash = os.path.join(args.workdir, f"crash_r{round_idx}")
                ring = os.path.join(crash, flight_lib.RING_NAME)
                train += ["--crash_dir", crash, "--fault_plan",
                          f"hang@epoch={args.kill_epoch}:step={last_step}:"
                          f"seconds={HOLD_LIMIT_S:g}"]
        _say(f"round {round_idx}: {n} rank(s) on {device}")
        proc = subprocess.Popen(_world_cmd(n, device, train, round_idx), env=_world_env(device))
        probe.reset_timer()
        resize: Optional[int] = None
        while proc.poll() is None:
            time.sleep(0.2)
            if ring is not None and not capacity_returned[0] and at_the_hold(ring):
                _say(f"capacity returns: allocation -> {args.devices}")
                capacity_lib.write_allocation(cap_file, args.devices)
                capacity_returned[0] = True
            if resize is None:
                target = probe.poll(n)
                if target is not None and target != n:
                    _say(f"probe: census wants {target} (running {n}) — checkpointing this "
                         "round for the resize")
                    resize = target
                    proc.send_signal(signal.SIGTERM)  # the launcher forwards it to its ranks
        rc = proc.returncode
        _say(f"round {round_idx}: exit {rc}")
        if round_idx == 0 and rc == PREEMPTION_EXIT_CODE:
            # the preemption took its cards: the census caps the relaunch
            capacity_lib.write_allocation(cap_file, args.shrink_to)
        return RoundResult(rc, {0: rc}, resize)

    rc = supervise(round_fn, nproc=args.devices, min_procs=args.shrink_to, max_restarts=3,
                   backoff_base=0.01, announce=lambda m: _say(f"supervisor: {m}"), probe=probe)
    if rc != 0:
        _say(f"FAIL: supervised elastic run exited {rc}")
        return 1

    recs = _load(elastic_log)
    resumes = [r for r in recs if r.get("kind") == "resume"]
    shrinks = [r for r in resumes
               if r.get("prev_dp") == args.devices and r.get("dp") == args.shrink_to]
    grows = [r for r in resumes
             if r.get("prev_dp") == args.shrink_to and r.get("dp") == args.devices]
    if not shrinks:
        _say(f"FAIL: no shrink resume record ({args.devices}->{args.shrink_to})")
        return 1
    if not grows:
        _say(f"FAIL: no grow resume record ({args.shrink_to}->{args.devices})")
        return 1
    keys = ("epoch", "world", "dp", "prev_dp", "resharded", "mid_epoch_step",
            "examples_offset", "restarts")
    for tag, rec in (("shrink", shrinks[0]), ("grow", grows[0])):
        _say(f"resume record ({tag}): {json.dumps({k: rec.get(k) for k in keys})}")
    _say(f"resume records: shrank dp {args.devices}->{args.shrink_to}, "
         f"grew dp {args.shrink_to}->{args.devices}")
    counters = [r.get("counters") for r in recs if isinstance(r.get("counters"), dict)]
    if not any(c.get("elastic.grows") for c in counters):
        _say("FAIL: elastic.grows counter never observed in the history")
        return 1

    golden = _epoch_losses(_load(golden_log))
    elastic = _epoch_losses(recs)
    for epoch, want in sorted(golden.items()):
        got = elastic.get(epoch)
        if got is None:
            _say(f"FAIL: elastic run has no epoch {epoch}")
            return 1
        rel = abs(got - want) / max(abs(want), 1e-12)
        _say(f"epoch {epoch}: golden loss {want:.6f}, elastic {got:.6f} (rel {rel:.2e})")
        if rel > LOSS_RTOL:
            _say(f"FAIL: loss diverged past rtol {LOSS_RTOL}")
            return 1
    _say(f"PASS grow: preempt-shrink {args.devices}->{args.shrink_to} ({shrink_device}), "
         f"probe-grow back to {args.devices} ({args.device}), trajectory within golden "
         "tolerance")
    return 0


# -- phase fleet -------------------------------------------------------------

_STUB_CHILD = """
import os, signal, sys, time
argv = sys.argv
n = int(argv[argv.index('--num_processes') + 1])
rank = int(argv[argv.index('--process_id') + 1])
if rank == 0:
    with open(os.environ['DRILL_MARKER'], 'a') as f:
        f.write(f"{n} resume={'--resume' in argv}\\n")
signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))
time.sleep(120)
"""


def _await(deadline: float, what: str, cond) -> bool:
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.2)
    _say(f"FAIL: timed out waiting for {what}")
    return False


def _worlds(marker: str) -> List[int]:
    if not os.path.exists(marker):
        return []
    with open(marker) as f:
        return [int(ln.split()[0]) for ln in f if ln.strip()]


def run_fleet_phase(args, timeout_s: float = 90.0) -> int:
    """Two supervised stub runs on one pool; the scheduler moves cards from
    the stalled run to the compute-bound one on scraped textfiles."""
    fleet_dir = os.path.join(args.workdir, "fleet")
    scheduler = FleetScheduler(
        [RunSpec("stalled", 4, min_procs=1), RunSpec("compute", 4, min_procs=1)],
        policy=FleetPolicy(), fleet_dir=fleet_dir,
        allocations={"stalled": 4, "compute": 2}, total_chips=6)
    launchers = {}
    markers = {}
    try:
        for run in ("stalled", "compute"):
            marker = os.path.join(fleet_dir, run, "worlds.txt")
            markers[run] = marker
            env = dict(os.environ)
            env["DRILL_MARKER"] = marker
            launchers[run] = subprocess.Popen(
                [sys.executable, "-m", "tpu_dist_torch.cli.launch",
                 "--nproc", "4", "--elastic_min_procs", "1",
                 "--elastic_max_restarts", "3", "--elastic_backoff", "0.01",
                 "--elastic_probe_interval", "0.3",
                 "--elastic_capacity_file", scheduler.allocation_path(run),
                 "--", sys.executable, "-c", _STUB_CHILD],
                env=env)
        deadline = time.monotonic() + timeout_s
        # both runs start at the sizes granted ("compute" asks for 4 and
        # the census starts it at its allocation of 2)
        if not _await(deadline, "runs to settle at allocations (4, 2)",
                      lambda: _worlds(markers["stalled"])[-1:] == [4]
                      and _worlds(markers["compute"])[-1:] == [2]):
            return 1
        _say("both runs settled: stalled@4, compute@2")

        # each run's exposition, written as the trainer writes it, then
        # scraped back by the scheduler
        sig = {}
        for run, stall, goodput, mfu in (("stalled", 0.62, 0.35, 0.08),
                                         ("compute", 0.02, 0.93, 0.52)):
            prom = os.path.join(fleet_dir, run, "metrics.prom")
            with open(prom, "w") as f:
                f.write(export_lib.render({
                    "train.data_stall_frac": stall, "goodput.goodput_frac": goodput,
                    "train.mfu": mfu, "train.epoch": 1}))
            sig[run] = read_signals(run, prom)
            if sig[run].data_stall_frac != stall:
                _say(f"FAIL: scrape of {prom} did not round-trip")
                return 1
        # tick 0: the pool is dry, so the stalled run DONATES; its cards
        # are pending until its relaunch has vacated them
        decisions = scheduler.step(0, sig, ts=time.time())
        if not decisions or decisions[0].get("action") != "donate":
            _say(f"FAIL: expected a donation at tick 0, got {decisions}")
            return 1
        d = decisions[0]
        _say(f"decision: {d['reason']} — alloc {d['alloc_before']} -> {d['alloc_after']}")
        if d["donor"] != "stalled" or d.get("for_run") != "compute":
            _say(f"FAIL: wrong donation {d}")
            return 1
        if not _await(deadline, "the donor to vacate (stalled->2)",
                      lambda: _worlds(markers["stalled"])[-1:] == [2]):
            return 1
        # tick 1: the pending cards mature and the compute-bound run gets them
        decisions = scheduler.step(1, sig, ts=time.time())
        if not decisions or decisions[0].get("action") != "grant":
            _say(f"FAIL: expected a grant at tick 1, got {decisions}")
            return 1
        g = decisions[0]
        _say(f"decision: {g['reason']} — alloc {g['alloc_before']} -> {g['alloc_after']}")
        if g["recipient"] != "compute" or g["donor"] is not None:
            _say(f"FAIL: wrong grant {g}")
            return 1
        if not _await(deadline, "the recipient to grow (compute->4)",
                      lambda: _worlds(markers["compute"])[-1:] == [4]):
            return 1
        hist = _load(scheduler.history_path())
        audited = [r for r in hist if r.get("kind") == "fleet" and r.get("inputs")]
        if len(audited) != 2:
            _say(f"FAIL: expected 2 auditable fleet records, got {len(audited)}")
            return 1
        _say("PASS fleet: stalled run donated 2 chips (worlds "
             f"{_worlds(markers['stalled'])}), compute-bound run was granted them one tick "
             f"later (worlds {_worlds(markers['compute'])}); both decisions audited with "
             "their scraped inputs")
        return 0
    finally:
        for proc in launchers.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in launchers.values():
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpu_dist_torch.fleet.drill",
                                description="preempt-shrink -> probe-grow -> fleet arbitration "
                                            "drill")
    p.add_argument("--workdir", required=True, help="scratch dir for ckpts/logs")
    p.add_argument("--devices", type=int, default=2, help="ranks of the full-size rounds")
    p.add_argument("--shrink_to", type=int, default=1, help="ranks of the shrunken round")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the golden and full-size ranks run")
    p.add_argument("--shrink_device", choices=("cuda", "cpu"), default=None,
                   help="where the shrunken round's ranks run (default: --device)")
    p.add_argument("--model", default="vit_tiny")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--steps_per_epoch", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--kill_epoch", type=int, default=1)
    p.add_argument("--kill_step", type=int, default=1)
    p.add_argument("--phase", choices=("all", "grow", "fleet"), default="all",
                   help="'grow' = golden + preempt-shrink + probe-grow parity (training "
                        "subprocesses); 'fleet' = the two-run arbitration (stub children, "
                        "fast); 'all' = both")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if args.phase in ("all", "grow"):
        if not 0 <= args.kill_epoch < args.epochs - 1:
            p.error(f"--kill_epoch {args.kill_epoch} must leave an epoch to grow into "
                    f"(--epochs {args.epochs})")
        if not 0 <= args.kill_step < args.steps_per_epoch - 1:
            p.error(f"--kill_step {args.kill_step} must leave the shrunken world a step of "
                    f"its epoch (--steps_per_epoch {args.steps_per_epoch})")
    os.makedirs(args.workdir, exist_ok=True)
    if args.phase in ("all", "grow"):
        rc = run_grow_phase(args)
        if rc != 0:
            return rc
    if args.phase in ("all", "fleet"):
        rc = run_fleet_phase(args)
        if rc != 0:
            return rc
    _say("PASS: all requested phases")
    return 0


if __name__ == "__main__":
    sys.exit(main())
