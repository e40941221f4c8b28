"""The training forensics drill: the port's counterpart of
``tpu_dist/obs/drill.py`` (``python -m tpu_dist_torch.obs.drill``).

1. **Wedge.** A real trainer (``python -m tpu_dist_torch.cli.train``,
   synthetic data) runs under the real launcher with the whole forensic
   kit (``--heartbeat_dir``, ``--metrics_dir``, ``--crash_dir`` and the
   watchdog options) and the fault ``hang@epoch=E:step=S``: at that step
   the rank stops beating but stays alive.
2. **Detect and capture.** The launcher's watchdog sees the frozen beat,
   sends SIGUSR1 (the rank's faulthandler dumps its threads, naming the
   hang), waits for the dump, then SIGTERM and SIGKILL, and assembles the
   postmortem.
3. **Verify**, in the JAX drill's words: the launcher exited non-zero and
   not 75; its stderr names the wedged worker and the stuck frame; the
   bundle's decoded flight ring ends at the wedged step, and its stack
   dump sits in the hang loop (``faults._hang``); a ``postmortem`` record
   landed in the run's JSONL.

The drill also times the chain from the launcher's stderr, each line
stamped as it arrives: the detection (the last beat that landed, from
the heartbeat file the killed rank left, to the wedge line), the dump's
wait (the SIGUSR1 request to the stuck-frame line) and SIGTERM to exit
(the stuck-frame line, after which the SIGTERM goes, to the line that
reports the worker's end). They are printed as one JSON object on a
``postmortem-drill: timings`` line.

It runs on the card by default and raises without one; ``--device cpu``
runs the trainer on the CPU. ``--model`` picks the model (``vit_tiny``,
as the JAX drill; ``resnet18`` at full width on the card), and anything
after ``--`` is passed on to the trainer (``--num_classes 100 --bf16``)::

    python -m tpu_dist_torch.obs.drill --workdir D [--device cpu] \\
        [--model resnet18 --batch_size 256] [-- --num_classes 100 --bf16]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

from tpu_dist_torch import resolve_device
from tpu_dist_torch.obs import flight as flight_lib
from tpu_dist_torch.obs import heartbeat as heartbeat_lib
from tpu_dist_torch.obs import postmortem as postmortem_lib

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the launcher's lines the timings read, in the order they come
_WEDGED = "WATCHDOG: worker 0 wedged"
_REQUESTED = "requesting all-threads stack dump"
_DUMPED = "stack dump:"
_EXITED = "WATCHDOG: worker 0 exited"


def _say(msg: str) -> None:
    print(f"postmortem-drill: {msg}", flush=True)


def _fail(msg: str) -> int:
    _say(f"FAIL: {msg}")
    return 1


def _run_stamped(cmd: List[str], timeout: float):
    """Run ``cmd`` in a session of its own, stamping each stderr line with
    ``time.monotonic()`` as it arrives. Returns ``(rc, stdout, [(t,
    line)])``; rc is None when ``timeout`` ran out, and then the whole
    session (the launcher and its children) is killed."""
    proc = subprocess.Popen(cmd, cwd=_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    err: list = []
    out: list = []

    def read_err():
        for line in proc.stderr:
            err.append((time.monotonic(), line))

    threads = [threading.Thread(target=read_err, daemon=True),
               threading.Thread(target=lambda: out.extend(proc.stdout), daemon=True)]
    for th in threads:
        th.start()
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # every process the round left behind
        except OSError:  # the session has ended already
            pass
        proc.wait()
        for th in threads:
            th.join(timeout=5)
    return rc, "".join(out), err


def _first(stamped, text: str) -> Optional[float]:
    return next((t for t, line in stamped if text in line), None)


def _timings(stamped, hb_path: str) -> dict:
    """Seconds of the chain's three intervals (None where a line is
    missing)."""
    t_wedge, t_req = _first(stamped, _WEDGED), _first(stamped, _REQUESTED)
    t_dump, t_exit = _first(stamped, _DUMPED), _first(stamped, _EXITED)
    beat = heartbeat_lib.read(hb_path) or {}
    last = beat.get("mono_s")

    def gap(a, b):
        return round(b - a, 3) if a is not None and b is not None else None

    return {"detect_s": gap(last, t_wedge), "dump_wait_s": gap(t_req, t_dump),
            "sigterm_to_exit_s": gap(t_dump, t_exit), "last_beat": beat}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.obs.drill",
        description="hang -> watchdog -> SIGUSR1 dump -> postmortem drill")
    p.add_argument("--workdir", required=True, help="scratch directory")
    p.add_argument("--device", default="cuda", help="the trainer's device (default cuda)")
    p.add_argument("--model", default="vit_tiny")
    p.add_argument("--steps_per_epoch", type=int, default=6)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--hang_epoch", type=int, default=0)
    p.add_argument("--hang_step", type=int, default=3)
    p.add_argument("--watchdog_timeout", type=float, default=10.0,
                   help="must exceed the longest gap between two beats of a healthy run of "
                        "--model (start-up to the first step)")
    p.add_argument("--watchdog_dump_grace", type=float, default=6.0)
    p.add_argument("--watchdog_grace", type=float, default=3.0)
    p.add_argument("--round_timeout", type=float, default=600.0,
                   help="cap on the whole launcher round: the drill never wedges its caller")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="-- more flags for the trainer")
    args = p.parse_args(argv)
    if args.hang_step >= args.steps_per_epoch:
        p.error(f"--hang_step {args.hang_step} is past the epoch's last step")
    resolve_device(args.device)  # no GPU and no --device cpu: raise here
    extra = list(args.train_args)
    if extra and extra[0] == "--":
        extra = extra[1:]

    args.workdir = os.path.abspath(args.workdir)  # the round runs from the repo root
    os.makedirs(args.workdir, exist_ok=True)
    log = os.path.join(args.workdir, "run.jsonl")
    fault = f"hang@epoch={args.hang_epoch}:step={args.hang_step}"
    launch_cmd = [
        sys.executable, "-m", "tpu_dist_torch.cli.launch", "--nproc", "1",
        "--heartbeat_dir", args.workdir, "--metrics_dir", args.workdir,
        "--crash_dir", args.workdir,
        "--watchdog_timeout", str(args.watchdog_timeout),
        "--watchdog_dump_grace", str(args.watchdog_dump_grace),
        "--watchdog_grace", str(args.watchdog_grace),
        "--",
        sys.executable, "-m", "tpu_dist_torch.cli.train", "--device", args.device,
        "--dataset", "synthetic", "--model", args.model,
        "--num_classes", "10", "--batch_size", str(args.batch_size),
        "--epochs", "2", "--steps_per_epoch", str(args.steps_per_epoch),
        # the epoch holds every step it asks for, the hang step among them
        "--synthetic_n", str(args.steps_per_epoch * args.batch_size),
        "--seed", "0", "--eval_every", "0",
        "--log_every", "2", "--log_file", log, "--fault_plan", fault, *extra,
    ]
    _say(f"wedging a real {args.model} run on {args.device} with {fault!r} under the "
         f"watchdog (timeout {args.watchdog_timeout:g}s)")
    rc, _, stamped = _run_stamped(launch_cmd, args.round_timeout)
    stderr = "".join(line for _, line in stamped)
    sys.stderr.write(stderr)
    if rc is None:
        return _fail(f"launcher round exceeded {args.round_timeout:.0f}s — the watchdog never "
                     "fired (is --watchdog_timeout sized right?)")
    _say(f"launcher exit {rc}")

    failures: List[str] = []
    if rc in (0, 75):
        failures.append(f"launcher exited {rc} — a wedge must be a crash, never clean / "
                        "requeue-75")
    if _WEDGED not in stderr:
        failures.append("watchdog never reported the wedged worker")
    if "stack dump: stuck in" not in stderr:
        failures.append("watchdog did not name the stuck frame from the SIGUSR1 dump")
    if "postmortem bundle written" not in stderr:
        failures.append("watchdog did not auto-invoke the postmortem")

    bundle_path = os.path.join(args.workdir, postmortem_lib.BUNDLE_NAME)
    if not os.path.exists(bundle_path):
        failures.append(f"no bundle at {bundle_path}")
    else:
        with open(bundle_path) as f:
            bundle = json.load(f)
        rank0 = next((r for r in bundle.get("ranks", []) if r.get("rank") == 0), None)
        if rank0 is None:
            failures.append("bundle holds no rank-0 report")
        else:
            if rank0.get("verdict") != "no-clean-exit":
                failures.append(f"rank-0 verdict {rank0.get('verdict')!r}, expected "
                                "'no-clean-exit' (the hard-kill signature)")
            else:
                _say("bundle verdict no-clean-exit ✓")
            ls = (rank0.get("flight") or {}).get("last_step") or {}
            if (ls.get("epoch"), ls.get("step")) != (args.hang_epoch, args.hang_step):
                failures.append(f"flight ring ends at epoch {ls.get('epoch')} step "
                                f"{ls.get('step')}, expected the wedged step "
                                f"({args.hang_epoch}, {args.hang_step})")
            else:
                _say(f"flight ring ends at the wedged step (epoch {ls.get('epoch')}, step "
                     f"{ls.get('step')}) ✓")
            stuck = (rank0.get("stack") or {}).get("stuck_frame") or ""
            if "_hang" not in stuck and "on_step" not in stuck:
                failures.append(f"stack dump names {stuck!r}, expected the hang site "
                                "(faults._hang / faults.on_step)")
            else:
                _say(f"stack dump names the hang site: {stuck} ✓")

    # the crash must be renderable from the run's own log
    pm_recs = []
    try:
        with open(log) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # the dead writer's torn tail
                if isinstance(rec, dict) and rec.get("kind") == "postmortem":
                    pm_recs.append(rec)
    except OSError:
        failures.append(f"run log {log} unreadable")
    if not pm_recs:
        failures.append("no 'postmortem' record in the run's JSONL — the watchdog's annotate "
                        "step did not land")
    else:
        _say("postmortem record landed in the run's JSONL ✓")

    ring = os.path.join(args.workdir, flight_lib.RING_NAME)
    try:
        dec = flight_lib.decode(ring)
        _say(f"ring decodes: {len(dec['records'])} record(s), {dec['torn_slots']} torn slot(s)")
    except OSError as e:
        failures.append(f"flight ring unreadable: {e}")

    timings = _timings(stamped, os.path.join(args.workdir, "hb.json"))
    _say("timings " + json.dumps(timings))
    if failures:
        for msg in failures:
            _say(f"FAIL: {msg}")
        return 1
    _say("PASS: wedge detected, stack captured, bundle assembled — the whole forensic chain "
         "holds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
