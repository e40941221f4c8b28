"""What ``--device_metrics`` costs a ResNet-18 training step on one card.

Runs the port's data-parallel step for ``resnet18_cifar100`` (global batch
256, bf16, SyncBN over a 1-rank NCCL group, fused SGD; random weights and
one fixed random batch, so no input pipeline, as ``obs/step_breakdown.py``)
built twice over one train state, with the flag off and on, and takes them
in pairs, off then on and on then off in turns, so that neither always
runs first. Each step ends with a synchronise; its wall time and its host
enqueue time (the call returning, before the sync) are kept. Prints the
medians of each, the median of the paired differences (on - off) with its
quartiles and range, the peak allocation of one step each way, and the
flag's own work a step (the parameters' copy and the scalars,
``obs/device_stats.py``) at the model's leaves: device ms with a head
start (``obs/timing.py``) and host us. The last line is one JSON object of
every number. Run from the root of a checkout, with one card::

    python -m tpu_dist_torch.obs.health_cost [--pairs 60]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from tpu_dist_torch.comm import mesh
from tpu_dist_torch.nn import resnet
from tpu_dist_torch.obs import timing
from tpu_dist_torch.obs.device_stats import compute_device_stats, snapshot
from tpu_dist_torch.obs.step_breakdown import _free_port
from tpu_dist_torch.train import optim, state, step


def _timed(fn, st, x, y, lr) -> tuple:
    """One step ended by a synchronise: (state, wall ms, host enqueue ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = fn(st, x, y, lr)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return st, (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3


def _peak(fn, st, x, y, lr) -> tuple:
    """(state, the peak bytes allocated during one step)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, _ = fn(st, x, y, lr)
    torch.cuda.synchronize()
    return st, torch.cuda.max_memory_allocated()


def _spread(xs: list) -> dict:
    q1, _, q3 = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q1, "q3": q3, "min": min(xs),
            "max": max(xs)}


def measure(pairs: int) -> dict:
    model = resnet.resnet18(device="cuda")
    st = state.TrainState.create(model, optim.SGD(fused=True))
    steps = {flag: step.make_train_step(optim.SGD(fused=True), sync_bn=True,
                                        compute_dtype=torch.bfloat16, device_metrics=flag)
             for flag in (False, True)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(256, 32, 32, 3, device="cuda", generator=gen)
    y = torch.randint(0, 100, (256,), device="cuda", generator=gen)
    lr = torch.full((), 0.1, device="cuda")
    for _ in range(3):
        for flag in (False, True):
            st, _ = steps[flag](st, x, y, lr)
    wall = {False: [], True: []}
    host = {False: [], True: []}
    for i in range(pairs):
        for flag in ((False, True) if i % 2 == 0 else (True, False)):
            st, w, h = _timed(steps[flag], st, x, y, lr)
            wall[flag].append(w)
            host[flag].append(h)
    peak = {}
    for flag in (False, True, False, True):
        st, p = _peak(steps[flag], st, x, y, lr)
        peak[flag] = max(peak.get(flag, 0), p)
    params = list(model.parameters())
    grads = [torch.randn_like(p) for p in params]

    def flag_work():
        return compute_device_stats(grads, snapshot(params), params)

    work_ms, work_us = timing.device_ms(flag_work, iters=20)
    return {
        "pairs": pairs,
        "leaves": len(params),
        "params": sum(p.numel() for p in params),
        "wall_ms": {"off": _spread(wall[False]), "on": _spread(wall[True]),
                    "on_minus_off": _spread([b - a for a, b in zip(wall[False], wall[True])])},
        "host_enqueue_ms": {"off": _spread(host[False]), "on": _spread(host[True]),
                            "on_minus_off": _spread([b - a for a, b in
                                                     zip(host[False], host[True])])},
        "peak_bytes": {"off": peak[False], "on": peak[True], "on_minus_off":
                       peak[True] - peak[False]},
        "flag_work": {"device_ms": work_ms, "host_us": work_us},
    }


def _fmt(s: dict) -> str:
    return (f"median {s['median']:.3f} (quartiles {s['q1']:.3f}-{s['q3']:.3f}, range "
            f"{s['min']:.3f}-{s['max']:.3f})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=60)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}; torch {torch.__version__}", flush=True)
    mesh.initialize_distributed("cuda", master_port=_free_port())
    try:
        rep = measure(args.pairs)
    finally:
        torch.distributed.destroy_process_group()
    rep["card"] = smi.strip()
    for key, label in (("wall_ms", "step ms (ended by a sync)"),
                       ("host_enqueue_ms", "host enqueue ms")):
        for side in ("off", "on", "on_minus_off"):
            print(f"{label:26s} {side:13s} {_fmt(rep[key][side])}", flush=True)
    pk = rep["peak_bytes"]
    print(f"peak bytes a step: off {pk['off']}, on {pk['on']} ({pk['on_minus_off']:+d})")
    fw = rep["flag_work"]
    print(f"the flag's own work at {rep['leaves']} leaves ({rep['params']} f32): device "
          f"{fw['device_ms']:.4f} ms, host {fw['host_us']:.1f} us")
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
