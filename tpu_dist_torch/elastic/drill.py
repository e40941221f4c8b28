"""The elastic drill, ``python -m tpu_dist_torch.elastic.drill``: the port's
counterpart of ``tpu_dist/elastic/drill.py``, a local proof of the elastic
contract in four phases:

1. **Golden**: an uninterrupted run of ``--devices`` ranks (ZeRO-1, so
   the optimizer state is a flat vector laid over the ranks, and with
   ``--grad_compression int8_ef`` the residuals too).
2. **Preempt**: the same run with a ``sigterm@epoch=E:step=S`` fault: the
   trainers finish the step, write the exact mid-epoch emergency snapshot
   and the launcher exits 75.
3. **Shrink + resume**: the same command at ``--shrink_to`` ranks with
   ``--resume``: the restore ladder remaps the checkpoint onto the new
   extent (the flat vectors re-laid) and the epoch continues past the
   consumed examples, on the batches the old world would have made.
4. **Verify**: the exit codes (0, 75, 0), the ``resume`` record's
   ``resharded`` flag and its ``prev_dp -> dp``, and each epoch's loss
   within :data:`LOSS_RTOL` of the golden run's.

A world of ``n`` is ``n`` processes under ``tpu_dist_torch.cli.launch
--nproc n``, one card each with ``--device cuda`` (the default) or gloo
ranks on the CPU with ``--device cpu``, asked for explicitly: a world
larger than the cards there are fails, naming the count, and never moves
to the CPU. ``--shrink_device`` puts the resumed phase on another device
than the first two (one card holds one rank, so a drill there runs its
first phases as CPU ranks and the resume on the card).

The defaults shrink 4 ranks to 1, where the JAX drill shrinks 8 emulated
devices to 4: ``vit_tiny`` ravels to 107,978 parameters, which 2 and 1
divide (at 2 -> 1 the flat momentum keeps its global shape and nothing is
re-laid) and 4 does not (padded to 107,980).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence

from tpu_dist_torch.resilience.preemption import PREEMPTION_EXIT_CODE

#: Relative loss tolerance, the JAX drill's: the resumed run repeats the
#: interrupted run's batches, reduced over another number of ranks, so
#: only the summation order differs.
LOSS_RTOL = 2e-3


def _say(msg: str) -> None:
    print(f"elastic-drill: {msg}", flush=True)


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


def _run_phase(name: str, n: int, device: str, train_args: List[str], extra_env: dict) -> int:
    env = dict(os.environ)
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")  # n ranks share the host's cores
    env.update(extra_env)
    cmd = [sys.executable, "-m", "tpu_dist_torch.cli.launch", "--nproc", str(n), "--",
           sys.executable, "-m", "tpu_dist_torch.cli.train", *train_args, "--device", device]
    _say(f"phase {name}: {n} rank(s) on {device}: {' '.join(train_args)}")
    rc = subprocess.call(cmd, env=env)
    _say(f"phase {name}: exit {rc}")
    return rc


def _load(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _epoch_losses(records: List[dict]) -> dict:
    return {rec.get("epoch"): rec["loss"]  # the last segment wins
            for rec in records
            if rec.get("kind") == "train_epoch" and isinstance(rec.get("loss"), (int, float))}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpu_dist_torch.elastic.drill",
                                description="preempt-at-step-k -> shrink -> parity drill")
    p.add_argument("--workdir", required=True, help="scratch dir for ckpts/logs")
    p.add_argument("--devices", type=int, default=4, help="ranks of the golden and preempt runs")
    p.add_argument("--shrink_to", type=int, default=1, help="ranks of the resumed run")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the golden and preempt ranks run")
    p.add_argument("--shrink_device", choices=("cuda", "cpu"), default=None,
                   help="where the resumed ranks run (default: --device)")
    p.add_argument("--model", default="vit_tiny")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps_per_epoch", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--kill_epoch", type=int, default=1)
    p.add_argument("--kill_step", type=int, default=1)
    p.add_argument("--grad_compression", default="none",
                   choices=("none", "bf16", "int8", "int8_ef"),
                   help="the drilled run's wire; 'none' (default) keeps the shrunk trajectory "
                        "inside the golden tolerance (the int8 modes draw their rounding per "
                        "rank, so another world rounds otherwise: parity, but noisier); "
                        "int8_ef also drills the residuals' remap")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser().parse_args(argv)
    shrink_device = args.shrink_device or args.device
    for n, device in ((args.devices, args.device), (args.shrink_to, shrink_device)):
        why = _check_world(n, device)
        if why:
            _say(f"FAIL: {why}")
            return 1
    os.makedirs(args.workdir, exist_ok=True)
    golden_log = os.path.join(args.workdir, "golden.jsonl")
    elastic_log = os.path.join(args.workdir, "elastic.jsonl")
    base = [
        "--dataset", "synthetic", "--model", args.model,
        "--num_classes", "10", "--synthetic_n", "256",
        "--batch_size", str(args.batch_size),
        "--epochs", str(args.epochs),
        "--steps_per_epoch", str(args.steps_per_epoch),
        "--eval_every", "0", "--save_every", "1", "--log_every", "50",
        "--seed", "0", "--shard_weight_update",
        "--grad_compression", args.grad_compression,
    ]
    rc = _run_phase("golden", args.devices, args.device,
                    base + ["--ckpt_dir", os.path.join(args.workdir, "ck_golden"),
                            "--log_file", golden_log], {})
    if rc != 0:
        _say(f"FAIL: golden run exited {rc}")
        return 1
    elastic_ck = os.path.join(args.workdir, "ck_elastic")
    rc = _run_phase("preempt", args.devices, args.device,
                    base + ["--ckpt_dir", elastic_ck, "--log_file", elastic_log,
                            "--fault_plan", f"sigterm@epoch={args.kill_epoch}:step={args.kill_step}"],
                    {})
    if rc != PREEMPTION_EXIT_CODE:
        _say(f"FAIL: preempted run exited {rc}, wanted {PREEMPTION_EXIT_CODE}")
        return 1
    rc = _run_phase("shrink-resume", args.shrink_to, shrink_device,
                    base + ["--ckpt_dir", elastic_ck, "--log_file", elastic_log, "--resume"],
                    {"TPU_DIST_ELASTIC_RESTARTS": "1"})
    if rc != 0:
        _say(f"FAIL: shrunk resume exited {rc}")
        return 1

    elastic_recs = _load(elastic_log)
    resumes = [r for r in elastic_recs if r.get("kind") == "resume"]
    if not resumes:
        _say("FAIL: no 'resume' record in the elastic log")
        return 1
    last = resumes[-1]
    if not last.get("resharded"):
        _say(f"FAIL: resume record not resharded: {last}")
        return 1
    keys = ("epoch", "world", "dp", "resharded", "prev_dp", "prev_procs", "mid_epoch_step",
            "examples_offset", "restarts")
    _say(f"resume record: {json.dumps({k: last.get(k) for k in keys})}")
    _say(f"resume record: epoch {last.get('epoch')} dp {last.get('prev_dp')} -> "
         f"{last.get('dp')}, resharded")
    golden = _epoch_losses(_load(golden_log))
    elastic = _epoch_losses(elastic_recs)
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
    _say(f"PASS: preempted at epoch {args.kill_epoch} step {args.kill_step} on {args.devices} "
         f"rank(s) ({args.device}), resumed on {args.shrink_to} ({shrink_device}), state "
         "resharded, trajectory within golden tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
