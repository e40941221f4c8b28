"""The serving drill: the port's counterpart of ``tpu_dist/serve/drill.py``
(``python -m tpu_dist_torch.serve drill``).

Replays a fixed request trace through the real engine on a
:class:`ManualClock` (no wall clock: queue waits, batch composition and
every histogram sample are reproducible bit for bit), from a real
checkpoint (written at a simulated dp = 4 ZeRO-1 layout, loaded through
the elastic remapper onto the serving extent of 1), with the real
histograms, SLO rules and history records, and asserts:

1. zero post-warmup retraces;
2. the histogram invariants: bucket counts sum to ``count``, every phase
   saw as many samples as completed requests, the phase sums account for
   at most the total latency; the OpenMetrics histogram family
   round-trips through ``export.parse``;
3. the ``compare --slo`` exit contract: a replay whose clock step is 5x
   (a latency regression) makes ``python -m tpu_dist_torch.obs compare
   --slo`` exit 1 against the baseline, a ~20% faster one exits 0.

Check 1 reads the port's ``compile.retraces`` counter, which eager
PyTorch never moves: the port compiles nothing per shape
(``serve/engine.py``), so the check holds by construction here and stays
to keep the drill's contract the JAX package's.

Run it: ``python -m tpu_dist_torch.serve drill --workdir DIR
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

#: Replay geometry (the JAX drill's): requests every 4 ms with 10 ms more
#: before every 7th, assembled in 16 ms ticks, a window every 3 ticks.
TRACE_SPACING_S = 0.004
TRACE_BURST_EXTRA_S = 0.01
TICK_S = 0.016
WINDOW_TICKS = 3
N_REQUESTS = 48
IMAGE_SHAPE = (16, 16, 3)
MAX_BATCH = 8
#: Manual-clock step per reading: baseline / injected regression /
#: improvement. The regression scales every phase 5x, far past compare's
#: 5%; the improvement is ~20% faster and must flag nothing.
BASE_STEP_S = 0.0005
REGRESSED_STEP_S = 0.0025
IMPROVED_STEP_S = 0.0004


class DrillError(AssertionError):
    """A drill invariant failed."""


class ManualClock:
    """Deterministic monotonic source: every reading advances the clock by
    ``auto_step_s`` (a fixed cost an observation, standing in for host and
    device time: scale it and every measured phase scales), and the replay
    :meth:`advance_to`\\s arrival boundaries."""

    def __init__(self, auto_step_s: float = 0.0):
        self.t = 0.0
        self.auto_step_s = auto_step_s
        self.readings = 0

    def __call__(self) -> float:
        self.t += self.auto_step_s
        self.readings += 1
        return self.t

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, t)


def _drill_model(device="cuda"):
    """The drill's narrow ResNet (the ``resnet18`` code path at miniature
    widths), as the JAX drill's ``ResNetDef``."""
    from tpu_dist_torch.nn.resnet import ResNet  # noqa: PLC0415

    return ResNet("basic", (1, 1, 1, 1), num_classes=10, widths=(8, 8, 16, 16),
                  device=device)


def default_trace(n: int = N_REQUESTS) -> List[float]:
    """The deterministic arrival offsets (seconds)."""
    return [
        round(TRACE_SPACING_S * i + (TRACE_BURST_EXTRA_S if i % 7 == 0 else 0.0), 6)
        for i in range(n)
    ]


def write_training_ckpt(ckpt_dir: str, model, *, dp: int = 4) -> dict:
    """Write the checkpoint a ZeRO-1 training run at ``dp`` would leave:
    ``model``'s parameters and BN statistics, one flat momentum vector
    padded to ``dp`` shards (a nonzero prefix, a zero pad tail), step 120,
    epoch 3 and the ``elastic`` stamp, through the port's ``ckpt.save``.
    Returns the written trees (JAX layout, host numpy), the momentum, the
    parameter count and the path."""
    import torch  # noqa: PLC0415

    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch import ckpt as ckpt_lib  # noqa: PLC0415
    from tpu_dist_torch.comm.quantize import padded_len  # noqa: PLC0415
    from tpu_dist_torch.elastic.remap import elastic_stamp, params_len  # noqa: PLC0415
    from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415

    L = params_len(model)
    mom = np.zeros((padded_len(L, dp),), np.float32)
    mom[:L] = np.arange(1, L + 1, dtype=np.float32) % 17 * 0.01
    state = TrainState(params=model, bn_state=dict(model.named_buffers()),
                       opt_state=torch.from_numpy(mom), step=120)
    path = ckpt_lib.save(ckpt_dir, state, epoch=3,
                         extra_meta={"elastic": elastic_stamp(dp, dp, L)})
    tree = bridge.keystr_unflatten(bridge.train_state_to_flat(state))
    return {"params": tree["params"], "bn_state": tree.get("bn_state", {}),
            "momentum": mom, "L": L, "path": path}


def replay(workdir: str, name: str, model, weights: dict, *, auto_step_s: float,
           trace: Optional[List[float]] = None, device="cuda") -> dict:
    """One deterministic replay of ``model`` with ``weights`` (JAX-layout
    trees, as :func:`~tpu_dist_torch.serve.engine.load_serving_state`
    returns them) -> ``{log, engine, stats, scalars, completed,
    retraces}``. The counter registry is reset first: each replay is its
    own run."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.metrics.history import MetricsHistory  # noqa: PLC0415
    from tpu_dist_torch.obs import counters as counters_lib  # noqa: PLC0415
    from tpu_dist_torch.serve import slo as slo_lib  # noqa: PLC0415
    from tpu_dist_torch.serve.engine import ServingEngine  # noqa: PLC0415

    counters_lib.reset()
    trace = trace if trace is not None else default_trace()
    rng = np.random.default_rng(42)  # one payload set a replay, fixed
    payloads = rng.standard_normal((len(trace),) + IMAGE_SHAPE).astype(np.float32)
    clock = ManualClock(auto_step_s=auto_step_s)
    log_path = os.path.join(workdir, f"{name}.jsonl")
    history = MetricsHistory(log_path, run_id=f"serve-drill-{name}")
    bridge.load_jax_params(model, weights["params"], weights["bn_state"])
    engine = ServingEngine(
        model, max_batch=MAX_BATCH, deadline_s=0.25,
        slo_rules=slo_lib.load_slo_rules("default"), history=history, clock=clock,
        device=device,
    )
    engine.warmup(IMAGE_SHAPE)
    done = []
    n_ticks = int(max(trace) // TICK_S) + 1
    i = 0
    for tick in range(n_ticks):
        window_end = (tick + 1) * TICK_S
        while i < len(trace) and trace[i] < window_end:
            engine.submit(payloads[i], id=i, arrival_s=trace[i])
            i += 1
        clock.advance_to(window_end)
        done.extend(engine.pump())
        if (tick + 1) % WINDOW_TICKS == 0:
            engine.record_window()
    done.extend(engine.drain())
    scalars = engine.record_window()
    history.close()
    for r in done:
        if r.result is None or r.result.shape != (10,) or not np.all(np.isfinite(r.result)):
            raise DrillError(f"request {r.id}: bad result {r.result!r}")
    return {
        "log": log_path,
        "engine": engine,
        "stats": engine.stats,
        "scalars": scalars,
        "completed": len(done),
        "retraces": counters_lib.get("compile.retraces"),
    }


def run_drill(workdir: str, fmt: str = "text", device="cuda") -> dict:
    """The whole proof; raises :class:`DrillError` on any broken invariant
    and returns the summary dict."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.obs import __main__ as obs_main  # noqa: PLC0415
    from tpu_dist_torch.obs import export as export_lib  # noqa: PLC0415
    from tpu_dist_torch.obs.summarize import load_records  # noqa: PLC0415
    from tpu_dist_torch.serve import slo as slo_lib  # noqa: PLC0415
    from tpu_dist_torch.serve.engine import load_serving_state  # noqa: PLC0415

    os.makedirs(workdir, exist_ok=True)
    model = _drill_model(device)

    # -- phase 1: checkpoint -> serving weights through the remapper --------
    ckpt_dir = os.path.join(workdir, "ckpt")
    saved = write_training_ckpt(ckpt_dir, model, dp=4)
    loaded = load_serving_state(ckpt_dir, model)
    if not any(kind == "zero1_flat" for _, kind in loaded["remapped"]):
        raise DrillError(
            "the dp=4 ZeRO-1 checkpoint restored without engaging the "
            f"elastic Remapper (remapped={loaded['remapped']})"
        )
    want, got = bridge.keystr_flatten(saved["params"]), bridge.keystr_flatten(loaded["params"])
    if list(want) != list(got) or not all(np.array_equal(want[k], got[k]) for k in want):
        raise DrillError("params changed across the restore")

    # -- phase 2: baseline replay + invariants ------------------------------
    base = replay(workdir, "baseline", model, loaded, auto_step_s=BASE_STEP_S, device=device)
    if base["retraces"]:
        raise DrillError(
            f"{base['retraces']:g} post-warmup retrace(s) — the bucket ladder leaked a shape"
        )
    if base["completed"] != N_REQUESTS:
        raise DrillError(f"completed {base['completed']}/{N_REQUESTS} requests")
    probs = base["stats"].check_invariants()
    if probs:
        raise DrillError("histogram invariants broken: " + "; ".join(probs))
    expo = export_lib.render({}, histograms=base["stats"].histogram_families())
    parsed = export_lib.parse(expo)
    count_key = export_lib.metric_name("serve.latency_seconds") + "_count"
    if parsed.get(count_key) != base["stats"].total.count:
        raise DrillError(
            f"exposition round-trip lost the histogram count "
            f"({parsed.get(count_key)} vs {base['stats'].total.count})"
        )

    # -- phase 3: injected regression / improvement -> compare --slo ---------
    reg = replay(workdir, "regressed", model, loaded, auto_step_s=REGRESSED_STEP_S,
                 device=device)
    imp = replay(workdir, "improved", model, loaded, auto_step_s=IMPROVED_STEP_S,
                 device=device)
    rc_reg = obs_main.main(["compare", base["log"], reg["log"], "--slo"])
    if rc_reg != 1:
        raise DrillError(
            f"obs compare --slo exited {rc_reg} on the injected latency regression (want 1)"
        )
    rc_imp = obs_main.main(["compare", base["log"], imp["log"], "--slo"])
    if rc_imp != 0:
        raise DrillError(
            f"obs compare --slo exited {rc_imp} on a faster candidate "
            "(want 0 — lower latency is never flagged)"
        )

    # -- report -------------------------------------------------------------
    records, _ = load_records(base["log"])
    report = slo_lib.serve_report(records)
    summary = {
        "workdir": workdir,
        "ckpt": loaded["path"],
        "remapped": loaded["remapped"],
        "requests": N_REQUESTS,
        "retraces_post_warmup": base["retraces"],
        "windows": report["n_windows"],
        "baseline": {
            k: base["scalars"].get(k)
            for k in ("serve.requests_per_s", "serve.latency_p50_ms",
                      "serve.latency_p99_ms", "serve.availability",
                      "serve.batch_occupancy")
        },
        "compare_slo": {"regression_rc": rc_reg, "improvement_rc": rc_imp},
    }
    if fmt == "json":
        print(json.dumps(summary, indent=2, default=str))
    else:
        print(slo_lib.format_report_text(report))
        print(
            f"serve-drill OK: {N_REQUESTS} requests, 0 post-warmup "
            f"retraces, histogram invariants hold, compare --slo "
            f"regression→{rc_reg} improvement→{rc_imp}"
        )
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.serve drill",
        description="deterministic serving drill: trace replay, retrace-"
                    "freedom, histogram invariants, compare --slo gate",
    )
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--device", default="cuda",
                    help="the device the replays serve on (default cuda)")
    args = ap.parse_args(argv)
    try:
        run_drill(args.workdir, fmt=args.format, device=args.device)
    except DrillError as e:
        print(f"serve-drill FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
