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

``--devices_per_proc`` other than 1 and the elastic supervisor's options
are not ported: each raises ``NotPortedError`` naming its ROADMAP item.
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

from tpu_dist_torch.obs import export as export_lib
from tpu_dist_torch.obs import flight as flight_lib
from tpu_dist_torch.obs import heartbeat as heartbeat_lib
from tpu_dist_torch.obs import postmortem as postmortem_lib
from tpu_dist_torch.resilience.preemption import PREEMPTION_EXIT_CODE
from tpu_dist_torch.train.step import NotPortedError

_ELASTIC = "Queue A 6 (elastic training, elastic/supervisor.py)"

# option -> (its default, the ROADMAP item it waits for)
UNPORTED = {
    "devices_per_proc": (1, "Queue A 6 (more than one card a process: the port runs one)"),
    "elastic_min_procs": (0, _ELASTIC),
    "elastic_max_restarts": (3, _ELASTIC),
    "elastic_backoff": (0.5, _ELASTIC),
    "elastic_probe_interval": (0.0, _ELASTIC),
    "elastic_max_procs": (0, _ELASTIC),
    "elastic_capacity_file": (None, _ELASTIC),
    "elastic_same_size_retries": (2, _ELASTIC),
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
        return _run_round(args, cmd, hb_base, metrics_base, live, launcher_sig)
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


def _run_round(args, cmd: List[str], hb_base: Optional[str], metrics_base: Optional[str],
               live: List[subprocess.Popen], launcher_sig: List[bool]) -> int:
    """Start ``args.nproc`` children at one rendezvous port and wait for
    them: fail fast on the first non-zero exit; the watchdog over their
    beats; 75 when the round ended preempted (the launcher's SIGTERM, or a
    child's own exit 75) and no child failed or wedged."""
    nproc = args.nproc
    port = args.port or _free_port()
    # files of ranks outside this world (left by a wider run) must not
    # read as dead workers, to the watchdog or to the postmortem
    stale = [b for b in (hb_base, metrics_base) if b]
    if args.crash_dir:
        stale += [os.path.join(args.crash_dir, flight_lib.RING_NAME),
                  os.path.join(args.crash_dir, flight_lib.STACKS_NAME)]
    swept = sum(heartbeat_lib.sweep_stale_ranks(base, nproc) for base in stale)
    if swept:
        _say(f"swept {swept} stale per-rank file(s) from ranks outside the new world of {nproc}")
    procs: List[subprocess.Popen] = []
    ranks: Dict[subprocess.Popen, int] = {}
    preempted = False
    try:
        for rank in range(nproc):
            env = {k: v for k, v in os.environ.items() if k not in _PLACEMENT_ENV}
            env["LOCAL_RANK"] = str(rank)  # one card a process: card `rank`
            child = cmd + ["--num_processes", str(nproc), "--process_id", str(rank),
                           "--ip", args.ip, "--port", str(port)]
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
            for pr in list(pending):
                ret = pr.poll()
                if ret is None:
                    # a preemption shutdown goes silent in its emergency
                    # save by design: the watchdog stands down
                    if dog is not None and not (preempted or launcher_sig[0]):
                        if dog.watch(pr, ranks[pr]) and crash_rc == 0:
                            crash_rc = 1  # a wedge is a failure, never a requeue-75
                    continue
                pending.remove(pr)
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
            return crash_rc
        if (preempted or launcher_sig[0]) and rc in (0, PREEMPTION_EXIT_CODE, -signal.SIGTERM):
            return PREEMPTION_EXIT_CODE
        return rc
    finally:
        for pr in procs:
            pr.kill()  # a no-op on children already reaped
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
