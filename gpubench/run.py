"""Run one cell of ``BENCHMARK.json`` once and print its result line.

From the root of a checkout, on a machine with the cards the cell asks for::

    python3 gpubench/run.py --workload vit_b16.i1024_b8 --seed 7 --seconds 30 --trace 0

A run builds the program from the seed, runs its first steps (which the
reference follows), warms up, measures a window of ``--seconds`` and, with
``--trace 1``, a profiled sub-window and the per-layer readers. Then it
frees the program, runs the plain reference over the same weights and
batches, compares (:mod:`gpubench.check`) and prints each compared number
beside its limit as the last lines of standard error, and one JSON object
as the last line of standard output. Without the cards it asks for, or
with a JAX module loaded by the end, it exits with another code than 0
and prints no result.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gpubench import check, traffic as gen, window  # noqa: E402
from gpubench import trace as trace_lib  # noqa: E402
from gpubench.manifest import Manifest  # noqa: E402
from gpubench.reference.train import follow  # noqa: E402

#: Top-level module names no run may hold once its window has closed.
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "tpu_dist"))
NO_CARD, LEAKED = 3, 4  # exit codes


def process_seconds() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _STARTED


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is in :data:`FORBIDDEN`,
    compared whole (``tpu_dist_torch`` is not ``tpu_dist``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> Optional[str]:
    """The card's ``nvidia-smi`` power limit, where it can be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


@dataclasses.dataclass
class Run:
    """What a metric's reader may read (``metrics/<name>.py::read(run)``)."""

    workload: str
    cfg: dict
    traffic: dict
    device: torch.device
    system: Any
    setup_s: float
    window: dict
    traced: Optional[dict] = None


def reference_record(model, entry, cfg: dict, traffic: dict, seed: int, device,
                     precision: str = "f32", jitter: float = 0.0) -> dict:
    """The reference's first steps from the seed's weights and batches,
    drawn again (``precision="fp8"``: the control; ``jitter``: each weight
    scaled by ``1 + jitter·N(0, 1)``, drawn from the seed)."""
    n = traffic["check_steps"]
    weights = gen.weights(model.weight_specs(cfg, traffic), seed, device)
    if jitter:
        g = gen.generator(seed, "jitter", device)
        for w in weights.values():
            w.mul_(1 + jitter * torch.randn(w.shape, generator=g, device=device))
    batches = entry.reference_batches(cfg, traffic, seed, device, n)
    rows = traffic.get("reference_rows") if model.REFERENCE.ROWS_INDEPENDENT else None
    return follow(model.REFERENCE.forward, weights, batches, cfg, precision=precision, rows=rows)


def _trace_fn(system, traffic: dict):
    if system.steps_per_call == 1:
        return lambda: [system.call(i) for i in range(traffic["trace_steps"])]
    return lambda: system.call(0, traffic["trace_steps"])


def run_cell(man: Manifest, name: str, seed: int, seconds: float, trace: bool, device,
             clock=process_seconds) -> dict:
    """One run of the cell ``name``; returns its result line as a dict."""
    device = torch.device(device)
    cell = man.workload(name)
    cfg, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    model, entry = man.model(cell["config"]), man.entry(traffic["entry"])
    limits = man.limits(name)
    system = entry.System(model, cfg, traffic, seed, device)
    prog = system.first_steps(traffic["check_steps"])
    system.warm_up()
    run = Run(name, cfg, traffic, device, system, clock(), {})
    run.window = window.measure(system, seconds, device)
    if trace:
        run.traced = trace_lib.capture(_trace_fn(system, traffic), device)
        run.traced["steps"] = traffic["trace_steps"]
    metrics = {}
    for m in man.metrics(name, per_layer=trace):
        value = man.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    system.close()
    run.system = system = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(prog, reference_record(model, entry, cfg, traffic, seed, device))
    losses = run.window["losses"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": run.window["peak_bytes"]}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": check.judge(numbers, limits), "attempted": len(losses),
              "failed": sum(1 for v in losses if not math.isfinite(v)),
              "metrics": metrics, "device": dev}
    if run.traced is not None and device.type == "cuda":
        dev["busy_s"], dev["window_s"] = run.traced["busy_s"], run.traced["window_s"]
        result["breakdown"] = {k: run.traced[k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return result


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    man = Manifest(ROOT)
    chips = man.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); {seen} visible", file=sys.stderr)
        return NO_CARD
    result = run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    leaked = forbidden_modules()
    if leaked:
        print(f"loaded in the run's process: {', '.join(leaked)}", file=sys.stderr)
        return LEAKED
    for k, v in result["checks"].items():
        print(f"{k} {v['value']:.6g} limit {v['limit']:.6g}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
