"""Local multi-process launcher, the ``torchrun`` role: the port's copy of
``tpu_dist/cli/launch.py`` (``main``, ``_run_round``, ``_auto_postmortem``)::

    python -m tpu_dist_torch.cli.launch --nproc 4 -- \\
        python -m tpu_dist_torch.cli.train --dataset synthetic --epochs 1

It starts ``--nproc`` copies of the command, each with
``--num_processes/--process_id/--ip/--port`` appended (``--port 0`` picks
a free port) and one card of its own (``LOCAL_RANK`` = its rank; the
launcher's own ``RANK``/``WORLD_SIZE``/``MASTER_*`` are not passed on, so
the flags place the rank). The first child to exit non-zero makes the
launcher SIGTERM the rest, as ``torchrun`` does.

Preemption contract: a SIGTERM to the launcher is forwarded to every
child; each trainer finishes its step, writes the emergency snapshot and
exits 75 (``PREEMPTION_EXIT_CODE``), and the launcher then exits 75 too,
so an orchestrator requeues the job (rerun it with ``--resume``) instead
of treating the preemption as a crash. A child that exits 75 on its own
makes the launcher exit 75 the same way; a real failure wins over it.

Watchdog contract (``tpu_dist/cli/launch.py:31-73``):

* ``--heartbeat_dir`` injects one base ``--heartbeat_file`` into every
  child; each rank beats its own ``per_rank_path`` file, and the launcher
  reads the same scheme back. ``--metrics_dir`` injects one base
  ``--metrics_file`` the same way, and ``--crash_dir`` the directory of
  each rank's flight ring and ``stacks.txt``. At spawn the files of ranks
  outside the world are swept (``heartbeat.sweep_stale_ranks``).
* With ``--watchdog_timeout`` S, a child that is alive but whose beat has
  not advanced for S seconds is wedged (a child that never beats is
  wedged too: spawn counts as its first advance). The launcher names the
  rank, its last position and, from its last exposition, why it was sick
  (``export.scrape``). With ``--crash_dir`` it first sends SIGUSR1 (the
  rank's faulthandler dumps every thread), waits until the dump has
  landed and stopped growing, at most ``--watchdog_dump_grace`` seconds,
  and names the stuck frame (``flight.stuck_frame``); then SIGTERM, and
  SIGKILL ``--watchdog_grace`` seconds later. After the round it
  assembles the postmortem bundle over the forensics directories and
  appends the ``postmortem`` record to the run's history.
* A wedge is a failure: the launcher exits non-zero and never 75, even
  when the dying child manages a graceful 75 (requeueing a deterministic
  wedge would loop the orchestrator on it).
* Once a preemption shutdown has begun the watchdog stands down: a child
  beats ``preempted`` and then goes silent in its emergency save by
  design.

Size the timeout above the longest gap between two beats of a healthy
run: start-up to the first step (CUDA and cuDNN set-up), or an epoch's
last step to the next beat (the epoch-end eval and checkpoint). Beside
the JAX launcher's lines, the port's says when a wedged worker's process
ended and how long after the SIGTERM. Only a beat that carries the
child's own ``pid`` counts, so a beat left on disk by an earlier process
never passes for this child's: until the child beats, it has not beaten.

Elastic contract (``tpu_dist/cli/launch.py:75-89``): with
``--elastic_min_procs`` set, the launcher is its own orchestrator for a
world that loses ranks. A round that ends preempted (exit 75) or with dead
ranks does not end the run: the supervisor (``elastic/supervisor.py``)
counts the ranks that survived (exits 0, 75 or the forwarded SIGTERM),
takes the largest feasible smaller world (a divisor of the original
``--nproc``, at least the floor), waits the deterministic backoff, and
relaunches the command with ``--resume`` appended and the round's index
as ``TPU_DIST_ELASTIC_RESTARTS`` in every child's environment (0 in a
launch without the supervisor, so no child inherits a stale count); the
trainer's restore re-lays the checkpoint onto the new world and the epoch
goes on past the examples already consumed. ``--elastic_max_restarts``
bounds the relaunches. A SIGTERM to the LAUNCHER itself still means "the
orchestrator wants the job gone": the policy stands down, before the
backoff and after it, and the launcher exits 75. Each round is a new set
of processes on a new rendezvous port; the previous round's children
are reaped before the next spawn, so no process group or CUDA context
outlives its round. Every round sweeps the files of ranks outside its
world.

Scale-up contract (``tpu_dist/cli/launch.py:91-109``): with
``--elastic_probe_interval`` set, the running round polls a capacity
census (``fleet/capacity.py``): the ``--elastic_capacity_file``
allocation file when given (the fleet scheduler's channel), else
``TPU_DIST_AVAILABLE_PROCS``, else the original ``--nproc``. When the
census staffs a larger feasible divisor (at most ``--elastic_max_procs``)
the round SIGTERMs its own world, every rank checkpoints and exits 75, and
the supervisor relaunches with ``--resume`` at the new size; a census
below the current size (a donation) takes the same path to a smaller
world, and a census also caps a failure relaunch. Grows are paced by a
deterministic cooldown; resizes charge no restart budget; the watchdog
stands down during a resize as during a preemption. The census rules from
the start: a census below ``--nproc`` launches round 0 at the granted
feasible size, and one below the floor refuses to start (exit 1). The
allocation file's decision tokens (``N decision=<id> cause=<cause>``) are
read once a round and stamped into every child's environment
(``TPU_DIST_FLEET_DECISION_ID``/``_CAUSE``), so the trainer's ``resume``
record names the fleet decision that moved the run.

``--devices_per_proc`` other than 1 raises ``NotPortedError`` citing
ROADMAP's "No port owed": in JAX it only sets the emulated CPU devices a
process (``tpu_dist/cli/launch.py:439-445``), and the port runs one card
a process.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from tpu_dist_torch.elastic import supervisor as supervisor_lib
from tpu_dist_torch.fleet import capacity as capacity_lib
from tpu_dist_torch.obs import export as export_lib
from tpu_dist_torch.obs import flight as flight_lib
from tpu_dist_torch.obs import heartbeat as heartbeat_lib
from tpu_dist_torch.obs import postmortem as postmortem_lib
from tpu_dist_torch.resilience.preemption import PREEMPTION_EXIT_CODE

# option -> (its default, the ROADMAP item it waits for)
UNPORTED = {
    "devices_per_proc": (1, 'Queue A "No port owed" (it sets JAX\'s emulated CPU devices a '
                            "process; the port runs one card a process)"),
}

# placement variables of an outer launcher, which would win over the flags
_PLACEMENT_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

#: Seconds between two polls of the children (exits, beats, dumps).
POLL_S = 0.25


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _say(msg: str) -> None:
    # stderr is the launcher's contract with the orchestrator
    print(f"launch: {msg}", file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tpu_dist_torch multi-process launcher")
    p.add_argument("--nproc", type=int, required=True, help="processes to start, one card each")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="0 = pick a free port")
    p.add_argument("--heartbeat_dir", default=None,
                   help="inject --heartbeat_file <dir>/hb.json into every child (rank k beats "
                        "<dir>/hb.json.h<k>) and watch the files for liveness")
    p.add_argument("--metrics_dir", default=None,
                   help="inject --metrics_file <dir>/metrics.prom into every child (per-rank "
                        "paths, as the heartbeat's), so the watchdog reports a wedged worker's "
                        "last exposition")
    p.add_argument("--crash_dir", default=None,
                   help="inject --crash_dir <dir> into every child (flight ring and stack "
                        "file a rank); the watchdog then asks a wedged rank for its stack dump "
                        "(SIGUSR1) and names the stuck frame before killing it, and a wedged "
                        "round ends with a postmortem bundle")
    p.add_argument("--watchdog_dump_grace", type=float, default=5.0, metavar="S",
                   help="with --crash_dir: seconds to wait for a wedged rank's stack dump "
                        "before the SIGTERM")
    p.add_argument("--watchdog_timeout", type=float, default=0.0, metavar="S",
                   help="with --heartbeat_dir: a live child whose beat has not advanced for S "
                        "seconds is wedged, reported and terminated; 0 disables. Must exceed "
                        "the longest gap between two beats of a healthy run")
    p.add_argument("--watchdog_grace", type=float, default=10.0, metavar="S",
                   help="seconds between the watchdog's SIGTERM and its SIGKILL")
    p.add_argument("--elastic_min_procs", type=int, default=0, metavar="N",
                   help="the elastic supervisor: when a round ends preempted (exit 75) or with "
                        "dead ranks, relaunch --resume at the largest feasible smaller world (a "
                        "divisor of --nproc), never below N; 0 (default): one round")
    p.add_argument("--elastic_max_restarts", type=int, default=3, metavar="K",
                   help="give up after K failure relaunches, surfacing the real exit code")
    p.add_argument("--elastic_backoff", type=float, default=0.5, metavar="S",
                   help="base of the deterministic backoff between relaunches "
                        "(S * 2^restart, at most 30 s)")
    p.add_argument("--elastic_probe_interval", type=float, default=0.0, metavar="S",
                   help="with the supervisor on: poll the capacity census every S seconds "
                        "while a round runs, and checkpoint and relaunch --resume at the size "
                        "it grants (a grow when cards return, a shrink when they were given "
                        "away); 0 (default) disables the probe")
    p.add_argument("--elastic_max_procs", type=int, default=0, metavar="N",
                   help="ceiling of the probe's grows (never above --nproc); 0: --nproc")
    p.add_argument("--elastic_capacity_file", default=None, metavar="PATH",
                   help="the allocation file the census reads (fleet/capacity.py); without "
                        "it TPU_DIST_AVAILABLE_PROCS, then --nproc")
    p.add_argument("--elastic_same_size_retries", type=int, default=2, metavar="K",
                   help="retries at the same size after a preemption of the whole world "
                        "before the supervisor steps down one divisor (floor permitting)")
    for flag, (default, _) in UNPORTED.items():
        kind = type(default) if default is not None else str
        p.add_argument(f"--{flag}", type=kind, default=default,
                       help=f"not ported (default {default})")
    p.add_argument("cmd", nargs=argparse.REMAINDER, help="-- command to run")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = parser()
    args = p.parse_args(argv)
    for flag, (default, queue) in UNPORTED.items():
        value = getattr(args, flag)
        if value != default:
            from tpu_dist_torch.train.step import NotPortedError  # noqa: PLC0415

            raise NotPortedError(flag, value, queue)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("missing command (after --)")
    if args.nproc < 1:
        p.error(f"--nproc must be >= 1, got {args.nproc}")
    if args.watchdog_timeout > 0 and not args.heartbeat_dir:
        p.error("--watchdog_timeout needs --heartbeat_dir (the liveness signal it watches)")
    if args.elastic_min_procs > args.nproc:
        p.error(f"--elastic_min_procs {args.elastic_min_procs} exceeds --nproc {args.nproc}")

    # one base path each, injected into every child; the ranks derive
    # their files from it (heartbeat.per_rank_path) and the watchdog reads
    # the same scheme back
    hb_base = metrics_base = None
    if args.heartbeat_dir:
        os.makedirs(args.heartbeat_dir, exist_ok=True)
        hb_base = os.path.join(args.heartbeat_dir, "hb.json")
    if args.metrics_dir:
        os.makedirs(args.metrics_dir, exist_ok=True)
        metrics_base = os.path.join(args.metrics_dir, "metrics.prom")
    if args.crash_dir:
        os.makedirs(args.crash_dir, exist_ok=True)

    live: List[subprocess.Popen] = []
    launcher_sig = [False]  # SIGTERM delivered to the launcher itself

    def _forward_sigterm(signum, frame):  # noqa: ARG001
        # the children run their own SIGTERM discipline (snapshot, exit
        # 75); the launcher keeps waiting for them instead of orphaning them
        launcher_sig[0] = True
        for pr in list(live):
            try:
                pr.send_signal(signal.SIGTERM)
            except OSError:  # the child is already gone
                pass

    try:
        prev_term = signal.signal(signal.SIGTERM, _forward_sigterm)
    except ValueError:  # not the main thread (embedded use)
        prev_term = None
    try:
        probe = None
        start_procs = None
        if args.elastic_min_procs > 0 and args.elastic_probe_interval > 0:
            probe = supervisor_lib.CapacityProbe(
                capacity_lib.make_census(args.elastic_capacity_file, default=args.nproc),
                original=args.nproc, min_procs=args.elastic_min_procs,
                max_procs=args.elastic_max_procs, interval=args.elastic_probe_interval)
            # the census rules from the start: a run whose cards are lent
            # out launches at the granted size, never on another run's cards
            avail = probe.available()
            if avail is not None and avail < args.nproc:
                granted = supervisor_lib.next_world_size(args.nproc, avail,
                                                         args.elastic_min_procs)
                if granted is None:
                    _say(f"elastic: capacity census grants only {avail} proc(s) — below "
                         f"min_procs={args.elastic_min_procs}; refusing to start")
                    return 1
                _say(f"elastic: capacity census grants {granted} of {args.nproc} proc(s) "
                     "at launch")
                start_procs = granted

        def round_fn(nproc: int, restart: int) -> supervisor_lib.RoundResult:
            return _run_round(args, cmd, nproc, restart, hb_base, metrics_base, live,
                              launcher_sig, probe)

        if args.elastic_min_procs <= 0:
            return round_fn(args.nproc, 0).rc
        return supervisor_lib.supervise(
            round_fn, nproc=args.nproc, min_procs=args.elastic_min_procs,
            max_restarts=args.elastic_max_restarts, backoff_base=args.elastic_backoff,
            announce=_say, should_continue=lambda: not launcher_sig[0], probe=probe,
            same_size_retries=args.elastic_same_size_retries, start_procs=start_procs)
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
        for pr in live:
            pr.kill()


class _Watchdog:
    """The per-rank state of the heartbeat watchdog over one round: the
    last beat seen and when it advanced, the stack dump in flight, the
    SIGKILL deadline, and the ranks declared wedged."""

    def __init__(self, args, hb_base: str, metrics_base: Optional[str], ranks: List[int]):
        self.args, self.hb_base, self.metrics_base = args, hb_base, metrics_base
        now = time.monotonic()
        # spawn counts as the first advance: a child that never beats is
        # as wedged as one that stopped
        self.seen: Dict[int, tuple] = {r: (None, now) for r in ranks}
        self.dump: Dict[int, list] = {}  # rank -> [deadline, size before, last size]
        self.kill_at: Dict[int, float] = {}
        self.term_at: Dict[int, float] = {}
        self.wedged: List[int] = []

    def _stack_path(self, rank: int) -> Optional[str]:
        if not self.args.crash_dir:
            return None
        return heartbeat_lib.per_rank_path(
            os.path.join(self.args.crash_dir, flight_lib.STACKS_NAME), rank)

    def _stack_size(self, rank: int) -> int:
        path = self._stack_path(rank)
        try:
            return os.path.getsize(path) if path else 0
        except OSError:
            return 0

    def _sick_report(self, rank: int) -> str:
        """Why the wedged worker was sick: the key gauges and active alerts
        of its last exposition; empty when there is none."""
        if self.metrics_base is None:
            return ""
        vals = export_lib.scrape(textfile=heartbeat_lib.per_rank_path(self.metrics_base, rank))
        if not vals:
            return ""
        parts = [f"{label} {v}" for label, v in export_lib.key_gauges(vals).items()]
        active = export_lib.active_labels(vals)
        if active:
            parts.append(f"active alerts: {', '.join(active)}")
        return f"; last exposition: {', '.join(parts)}" if parts else ""

    def _terminate(self, pr, rank: int, t: float) -> None:
        self.kill_at[rank] = t + self.args.watchdog_grace
        self.term_at[rank] = t
        try:
            pr.send_signal(signal.SIGTERM)
        except OSError:  # the child is already gone
            pass

    def watch(self, pr, rank: int) -> bool:
        """One poll of a live child; True when it was just declared wedged."""
        t = time.monotonic()
        if rank in self.kill_at:
            if t >= self.kill_at[rank]:
                pr.kill()  # the SIGTERM grace ran out: it really is stuck
            return False
        if rank in self.dump:
            # the dump lands and settles (two polls of the same size), or
            # the grace runs out: a dead interpreter never answers
            deadline, size0, last_size = self.dump[rank]
            size = self._stack_size(rank)
            if t < deadline and (size <= size0 or size != last_size):
                self.dump[rank][2] = size
                return False
            parsed = (flight_lib.read_stack_dump(self._stack_path(rank), offset=size0)
                      if size > size0 else None)
            frame = flight_lib.stuck_frame(parsed) if parsed else None
            _say(f"WATCHDOG: worker {rank} stack dump: "
                 + (f"stuck in {frame} ({len(parsed['threads'])} thread(s) dumped)" if frame
                    else "no dump captured (interpreter not answering SIGUSR1 — likely stuck "
                         "in native code)"))
            del self.dump[rank]
            self._terminate(pr, rank, t)
            return False
        rec = heartbeat_lib.read(heartbeat_lib.per_rank_path(self.hb_base, rank))
        if rec is not None and rec.get("pid") != pr.pid:
            rec = None  # another process's beat (a dead run's) is no beat of this child
        beat = rec.get("counter") if rec else None
        last_beat, last_adv = self.seen[rank]
        if beat != last_beat:
            self.seen[rank] = (beat, t)
            return False
        stalled = t - last_adv
        if stalled < self.args.watchdog_timeout:
            return False
        # wedged: alive but silent, which no exit code would ever report
        where = (f"epoch {rec.get('epoch')} step {rec.get('step')} phase {rec.get('phase')!r}"
                 if rec else "before its first beat")
        _say(f"WATCHDOG: worker {rank} wedged — heartbeat stalled {stalled:.0f}s at {where}; "
             f"terminating (~{stalled:.0f}s goodput loss on this host)" + self._sick_report(rank))
        self.wedged.append(rank)
        if self.args.crash_dir:
            # ask the frozen interpreter where it is first (its
            # faulthandler dumps every thread on SIGUSR1)
            size0 = self._stack_size(rank)
            try:
                pr.send_signal(signal.SIGUSR1)
            except OSError:  # the child is already gone
                pass
            self.dump[rank] = [t + self.args.watchdog_dump_grace, size0, size0]
            _say(f"WATCHDOG: requesting all-threads stack dump from worker {rank} (SIGUSR1), "
                 f"waiting up to {self.args.watchdog_dump_grace:.0f}s before escalating")
            return True
        self._terminate(pr, rank, t)
        return True

    def reaped(self, rank: int, ret: int) -> None:
        """A wedged worker's process ended."""
        if rank in self.term_at:
            _say(f"WATCHDOG: worker {rank} exited {ret} "
                 f"{time.monotonic() - self.term_at[rank]:.2f}s after SIGTERM")


def _run_round(args, cmd: List[str], nproc: int, restart: int, hb_base: Optional[str],
               metrics_base: Optional[str], live: List[subprocess.Popen],
               launcher_sig: List[bool], probe=None) -> supervisor_lib.RoundResult:
    """Start ``nproc`` children at one fresh rendezvous port and wait for
    them: fail fast on the first non-zero exit; the watchdog over their
    beats; 75 when the round ended preempted (the launcher's SIGTERM, a
    child's own exit 75, or the probe's resize) and no child failed or
    wedged. Returns the exit code with every rank's raw exit status (the
    supervisor's census of survivors) and, when the probe stood the world
    down, ``resize_to``. ``restart`` is the round's index: a round after
    the first appends ``--resume``, and every child reads the index from
    ``TPU_DIST_ELASTIC_RESTARTS``."""
    port = args.port or _free_port()
    # files of ranks outside this world (left by a wider round) must not
    # read as dead workers, to the watchdog or to the postmortem
    stale = [b for b in (hb_base, metrics_base) if b]
    if args.crash_dir:
        stale += [os.path.join(args.crash_dir, flight_lib.RING_NAME),
                  os.path.join(args.crash_dir, flight_lib.STACKS_NAME)]
    swept = sum(heartbeat_lib.sweep_stale_ranks(base, nproc) for base in stale)
    if swept:
        _say(f"swept {swept} stale per-rank file(s) from ranks outside the new world of {nproc}")
    # every child's environment but its card: the round index (round 0
    # stamps 0 too, so no child inherits a stale count from the launcher's
    # own environment) and the fleet decision this round carries out, read
    # once for the whole world (a rewrite of the file mid-spawn must not
    # split it; a stale id in the launcher's environment is dropped)
    base_env = {k: v for k, v in os.environ.items() if k not in _PLACEMENT_ENV}
    base_env["TPU_DIST_ELASTIC_RESTARTS"] = str(restart)
    meta = supervisor_lib.stamp_decision_env(base_env, args.elastic_capacity_file)
    if restart > 0 and meta["decision_id"] is not None:
        _say(f"relaunch actuates fleet decision {meta['decision_id']}"
             + (f" ({meta['cause']})" if meta["cause"] else ""))
    if probe is not None:
        probe.reset_timer()  # a new world gets a whole interval before any resize
    procs: List[subprocess.Popen] = []
    ranks: Dict[subprocess.Popen, int] = {}
    exits: Dict[int, int] = {}
    preempted = False
    resize_to: Optional[int] = None
    try:
        for rank in range(nproc):
            env = dict(base_env, LOCAL_RANK=str(rank))  # one card a process: card `rank`
            child = cmd + ["--num_processes", str(nproc), "--process_id", str(rank),
                           "--ip", args.ip, "--port", str(port)]
            if restart > 0 and "--resume" not in cmd:
                child.append("--resume")  # the relaunched world continues the run
            if hb_base is not None:
                child += ["--heartbeat_file", hb_base]
            if metrics_base is not None:
                child += ["--metrics_file", metrics_base]
            if args.crash_dir is not None:
                child += ["--crash_dir", args.crash_dir]
            pr = subprocess.Popen(child, env=env)
            procs.append(pr)
            live.append(pr)
            ranks[pr] = rank
        dog = (_Watchdog(args, hb_base, metrics_base, list(range(nproc)))
               if args.watchdog_timeout > 0 else None)
        rc = 0
        crash_rc = 0  # the first exit that is neither clean, preempted, nor our SIGTERM
        pending = list(procs)
        while pending:
            if (probe is not None and resize_to is None and not preempted
                    and not launcher_sig[0] and crash_rc == 0):
                target = probe.poll(nproc)
                if target is not None and target != nproc:
                    # the capacity changed: every rank checkpoints and
                    # exits 75, and the supervisor relaunches at the target
                    resize_to = target
                    _say(f"elastic: capacity census wants world size {target} (running "
                         f"{nproc}) — checkpointing this round for the resize")
                    for pr in pending:
                        try:
                            pr.send_signal(signal.SIGTERM)
                        except OSError:  # the child is already gone
                            pass
            for pr in list(pending):
                ret = pr.poll()
                if ret is None:
                    # a preemption or resize shutdown goes silent in its
                    # emergency save by design: the watchdog stands down
                    if dog is not None and not (preempted or launcher_sig[0]
                                                or resize_to is not None):
                        if dog.watch(pr, ranks[pr]) and crash_rc == 0:
                            crash_rc = 1  # a wedge is a failure, never a requeue-75
                    continue
                pending.remove(pr)
                exits[ranks[pr]] = ret
                if dog is not None:
                    dog.reaped(ranks[pr], ret)
                if ret == PREEMPTION_EXIT_CODE:
                    preempted = True
                elif ret not in (0, -signal.SIGTERM) and crash_rc == 0:
                    crash_rc = ret
                if ret != 0 and rc == 0:
                    rc = ret
                    for other in pending:  # fail fast, as torchrun does
                        other.send_signal(signal.SIGTERM)
            if pending:
                try:
                    pending[0].wait(timeout=POLL_S)
                except subprocess.TimeoutExpired:
                    pass
        if dog is not None and dog.wedged and args.crash_dir:
            # the forensic epilogue; it never changes the exit code
            _auto_postmortem(args, dog.wedged)
        if crash_rc:
            # a crash or wedge outranks a preemption and a resize: the
            # supervisor's failure path must see the real census
            return supervisor_lib.RoundResult(crash_rc, exits)
        if ((preempted or launcher_sig[0] or (resize_to is not None and rc != 0))
                and rc in (0, PREEMPTION_EXIT_CODE, -signal.SIGTERM)):
            return supervisor_lib.RoundResult(PREEMPTION_EXIT_CODE, exits, resize_to)
        return supervisor_lib.RoundResult(rc, exits)
    finally:
        for pr in procs:
            pr.kill()  # a no-op on children already reaped
            pr.wait()  # reaped before any next round spawns
            if pr in live:
                live.remove(pr)


def _auto_postmortem(args, wedged: List[int]) -> None:
    """Assemble the postmortem over every forensics directory this
    launcher injected, write the bundle, append the ``postmortem`` record
    to the run's history (when one is found), and name each wedged rank's
    verdict on stderr. Best effort: a broken postmortem says so and
    returns."""
    dirs = [d for d in (args.crash_dir, args.heartbeat_dir, args.metrics_dir) if d]
    try:
        report, bundle = postmortem_lib.run_postmortem(dirs, annotate=True)
    except Exception as e:  # noqa: BLE001 — the exit code must not depend on it
        _say(f"postmortem assembly failed: {e}")
        return
    if bundle is None:
        _say("postmortem: no forensic artifacts found")
        return
    _say(f"postmortem bundle written to {bundle}")
    for r in report["ranks"]:
        if r["rank"] not in wedged:
            continue
        stuck = (r.get("stack") or {}).get("stuck_frame")
        ls = (r.get("flight") or {}).get("last_step")
        _say(f"postmortem: rank {r['rank']} verdict {r['verdict']}"
             + (f", stuck in {stuck}" if stuck else "")
             + (f", flight ring ends at epoch {ls.get('epoch')} step {ls.get('step')}"
                if ls else ""))


if __name__ == "__main__":
    sys.exit(main())
