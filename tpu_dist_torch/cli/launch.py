"""Local multi-process launcher, the ``torchrun`` role: the port's copy of
the core of ``tpu_dist/cli/launch.py`` (``main``, ``_run_round``)::

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

The JAX launcher's watchdog, heartbeat, live-metrics and crash-forensics
options and its elastic supervisor are not ported: each raises
``NotPortedError`` naming its ROADMAP item, as does ``--devices_per_proc``
other than 1 (the port runs one card per process).
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
from typing import List, Optional, Sequence

from tpu_dist_torch.resilience.preemption import PREEMPTION_EXIT_CODE
from tpu_dist_torch.train.step import NotPortedError

_TELEMETRY = "Queue A 6 (telemetry: obs/heartbeat.py, obs/export.py, obs/flight.py)"
_ELASTIC = "Queue A 6 (elastic training, elastic/supervisor.py)"

# option -> (its default, the ROADMAP item it waits for)
UNPORTED = {
    "devices_per_proc": (1, "Queue A 6 (more than one card a process: the port runs one)"),
    "heartbeat_dir": (None, _TELEMETRY),
    "metrics_dir": (None, _TELEMETRY),
    "crash_dir": (None, _TELEMETRY),
    "watchdog_timeout": (0.0, _TELEMETRY),
    "watchdog_grace": (10.0, _TELEMETRY),
    "watchdog_dump_grace": (5.0, _TELEMETRY),
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tpu_dist_torch multi-process launcher")
    p.add_argument("--nproc", type=int, required=True, help="processes to start, one card each")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="0 = pick a free port")
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
        return _run_round(args, cmd, live, launcher_sig)
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
        for pr in live:
            pr.kill()


def _run_round(args, cmd: List[str], live: List[subprocess.Popen],
               launcher_sig: List[bool]) -> int:
    """Start ``args.nproc`` children at one rendezvous port and wait for
    them: fail fast on the first non-zero exit; 75 when the round ended
    preempted (the launcher's SIGTERM, or a child's own exit 75) and no
    child failed otherwise."""
    port = args.port or _free_port()
    procs: List[subprocess.Popen] = []
    preempted = False
    try:
        for rank in range(args.nproc):
            env = {k: v for k, v in os.environ.items() if k not in _PLACEMENT_ENV}
            env["LOCAL_RANK"] = str(rank)  # one card a process: card `rank`
            child = cmd + ["--num_processes", str(args.nproc), "--process_id", str(rank),
                           "--ip", args.ip, "--port", str(port)]
            pr = subprocess.Popen(child, env=env)
            procs.append(pr)
            live.append(pr)
        rc = 0
        crash_rc = 0  # the first exit that is neither clean, preempted, nor our SIGTERM
        pending = list(procs)
        while pending:
            for pr in list(pending):
                ret = pr.poll()
                if ret is None:
                    continue
                pending.remove(pr)
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
                    pending[0].wait(timeout=1)
                except subprocess.TimeoutExpired:
                    pass
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


if __name__ == "__main__":
    sys.exit(main())
