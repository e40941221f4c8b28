#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_dist_torch``) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card visible::

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. build: compile every CUDA source under ``tpu_dist_torch/csrc/`` with
   ``nvcc`` (one process per source, all started together) into
   ``tpu_dist_torch/csrc/build/``.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at edge cases (causal, bf16, ragged S, other
   head dims), with the tolerance of each; CUDA-event times of the
   kernel, its plain version and one library call computing the same
   function (a yardstick the port never calls).
3. serve: ViT-B/16 at full width, random weights from a numpy seed carried
   in through the bridge, served by ``ServingEngine(max_batch=8)`` with
   ``attn_impl="flash"``: warmup, then 32 requests in alternating 3- and
   7-request bursts. Launch counts are set to 0 just before and read just
   after; every request must complete with finite logits, the flash kernel
   must have run 12 times per forward, and the logits must agree with the
   same engine run with ``attn_impl="xla"``.
4. report: the card's name and power limit, one JSON line of every ported
   kernel, and the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpu_dist_torch import bridge
from tpu_dist_torch.nn.vit import vit_b16
from tpu_dist_torch.obs import counters as counters_lib
from tpu_dist_torch.ops import _build
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.serve.engine import ServingEngine

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_F32_FLOPS = 67e12       # CUDA cores, f32 (the kernel's products)
PEAK_BYTES_PER_S = 3.35e12   # HBM3

SERVE_MAX_BATCH = 8
SERVE_REQUESTS = 32
SERVE_SEED = 0
IMAGE = (224, 224, 3)
VIT_B16_FWD_SHAPE = (SERVE_MAX_BATCH * 12, 196, 64)  # [BH, S, D] of one full batch

# (max |kernel - plain|) limits: err <= atol + rtol * |plain|.
# f32: both sum in f32 but in another order (64-key tiles with online
#   rescaling vs one softmax over the row; expf vs torch.exp), a few ulps.
# bf16 out: both round nearly the same f32 value to bf16, so they differ
#   by one bf16 step (at most 2^-7 relative) where the f32 values straddle
#   a rounding boundary; two steps are allowed, plus the f32 floor for
#   values near 0, where one f32 ulp of difference can flip several bf16
#   steps. m and l stay f32.
TOL = {
    "out_f32": (2e-5, 1e-5),
    "out_bf16": (2e-5, 2 ** -6),
    "m": (2e-5, 1e-5),
    "l": (0.0, 2e-5),
}
# ViT-B/16 logits, flash vs xla attention on the card: the attention
# outputs differ by f32 rounding (~1e-6) and 12 blocks carry that on.
LOGITS_TOL = (1e-3, 1e-3)

KERNELS = {
    "flash_attention_fwd": {
        "route": "cuda",
        "source": "tpu_dist_torch/csrc/flash_attention_fwd.cu",
        "replaces": "tpu_dist/ops/flash_attention.py:152",
    },
}


class SmokeError(AssertionError):
    """A phase of the smoke run failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after ``warmup`` calls; inputs stay L2-warm, as they are
    when the model produces them just before)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(bh: int, s: int, d: int):
    """Least time for one f32 flash forward: q, k, v read once, out, m, l
    written once, over the HBM rate; the two products (4 * BH * S^2 * D
    operations, non-causal) over the f32 peak."""
    nbytes = 4 * (4 * bh * s * d + 2 * bh * s)
    flops = 4 * bh * s * s * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 1 -----------------------------------------------------------------


def phase_build() -> None:
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    check(sorted(KERNELS) == names, f"csrc sources {names} vs kernels {sorted(KERNELS)}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        results = dict(zip(names, ex.map(_build.build, names)))
    for name, (path, seconds, log) in results.items():
        print(f"[build] {name}: {seconds:.1f} s -> {path.name}")
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all sources: {time.perf_counter() - t0:.1f} s wall")


# -- phase 2 -----------------------------------------------------------------


def _err(a, b, atol, rtol):
    """(max |a - b|, ok) with ok iff |a - b| <= atol + rtol * |b| everywhere."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    return diff.max().item(), bool((diff <= atol + rtol * b.abs()).all())


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    bh, s, d = VIT_B16_FWD_SHAPE
    cases = [
        # name, (BH, S, D), causal, input dtype, out_dtype
        ("vit_b16 f32", (bh, s, d), False, f32, None),
        ("vit_b16 f32 causal", (bh, s, d), True, f32, None),
        ("vit_b16 bf16", (bh, s, d), False, bf16, None),
        ("vit_b16 bf16 in, f32 out", (bh, s, d), False, bf16, f32),
        ("ragged S=77 D=32", (24, 77, 32), False, f32, None),
        ("ragged S=77 D=128 causal", (24, 77, 128), True, f32, None),
        ("ragged S=77 D=16 bf16 causal", (24, 77, 16), True, bf16, None),
        ("S=5 D=64 causal (one partial tile)", (4, 5, 64), True, f32, None),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for name, shape, causal, dt, odt in cases:
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dt) for _ in range(3))
        out, m, l = fa.flash_fwd(q, k, v, causal, odt)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        r_out, r_m, r_l = fa.flash_fwd_reference(q, k, v, causal, odt)
        check(out.dtype == r_out.dtype and out.shape == r_out.shape,
              f"{name}: out {out.dtype} {tuple(out.shape)} vs {r_out.dtype} {tuple(r_out.shape)}")
        tol_out = TOL["out_bf16" if out.dtype == bf16 else "out_f32"]
        e_out, ok_out = _err(out, r_out, *tol_out)
        e_m, ok_m = _err(m, r_m, *TOL["m"])
        e_l, ok_l = _err(l, r_l, *TOL["l"])
        print(f"[kernels] flash_attention_fwd {name}: max|err| out {e_out:.3g} "
              f"m {e_m:.3g} l {e_l:.3g}")
        check(ok_out and ok_m and ok_l, f"flash_attention_fwd {name}: outside tolerance")
        check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
        if main_err is None:
            main_err = e_out

    q, k, v = (torch.randn(VIT_B16_FWD_SHAPE, device="cuda", generator=gen) for _ in range(3))
    q4, k4, v4 = (t.view(SERVE_MAX_BATCH, 12, s, d) for t in (q, k, v))
    kernel_ms = cuda_ms(lambda: fa.flash_fwd(q, k, v))
    plain_ms = cuda_ms(lambda: fa.flash_fwd_reference(q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
    bound_ms, bound_by = flash_bound(bh, s, d)
    print(f"[kernels] flash_attention_fwd at [BH, S, D] = {list(VIT_B16_FWD_SHAPE)} f32: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return {"flash_attention_fwd": {
        "max_abs_err": main_err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }}


# -- phase 3 -----------------------------------------------------------------


def _serve(model, payloads):
    """Warm an engine up, then drive the bursty request stream through it.
    Returns (engine, completed requests, scalars of the measured window)."""
    engine = ServingEngine(model, max_batch=SERVE_MAX_BATCH, device="cuda")
    engine.warmup(IMAGE)
    engine.record_window()  # the measured window opens after warmup
    done, submitted, burst_idx = [], 0, 0
    while submitted < len(payloads):
        # alternate 3- and 7-request bursts so several buckets are used
        burst = (3, 7)[burst_idx % 2]
        burst_idx += 1
        for _ in range(min(burst, len(payloads) - submitted)):
            engine.submit(payloads[submitted], id=submitted)
            submitted += 1
        done.extend(engine.pump())
    done.extend(engine.drain())
    return engine, done, engine.record_window()


def _forward_split(model, batch: np.ndarray) -> None:
    """One full-bucket forward, outside the engine: the host's time to
    enqueue it (from an idle card) against the card's time between
    back-to-back forwards (CUDA events; host-bound when they are close).
    In turns, so drift on the shared host shows."""
    x = torch.from_numpy(batch).to("cuda")
    for impl in ("flash", "xla", "xla", "flash"):
        model.attn_impl = impl
        with torch.inference_mode():
            period_ms = cuda_ms(lambda: model(x), iters=20, warmup=3)
            enqueue = []
            for _ in range(10):
                torch.cuda.synchronize()
                t = time.perf_counter()
                model(x)
                enqueue.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
        print(f"[serve] {impl}: batch-{x.shape[0]} forward: host enqueue "
              f"{float(np.median(enqueue)):.3f} ms (median of 10), device period "
              f"{period_ms:.3f} ms (CUDA events, 20 back to back)")


def phase_serve() -> dict:
    t0 = time.perf_counter()
    model = vit_b16(attn_impl="flash", device="cuda")
    bridge.load_jax_vit(model, bridge.numpy_vit_params(model, seed=SERVE_SEED))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 86_566_120, f"vit_b16 has {n_params} parameters")
    payloads = np.random.default_rng(SERVE_SEED).standard_normal(
        (SERVE_REQUESTS,) + IMAGE, dtype=np.float32)
    print(f"[serve] vit_b16 ({n_params} parameters) built and bridged in "
          f"{time.perf_counter() - t0:.1f} s")

    # the main path: counts set to 0 just before, read just after
    counters_lib.reset()
    fa.flash_fwd.launches = 0
    engine, done, scalars = _serve(model, payloads)
    launches = fa.flash_fwd.launches
    forwards = counters_lib.get("serve.forwards")

    check(len(done) == SERVE_REQUESTS and all(r.ok for r in done),
          f"{sum(r.ok for r in done)} of {SERVE_REQUESTS} requests completed")
    for r in done:
        check(r.result.shape == (1000,) and bool(np.isfinite(r.result).all()),
              f"request {r.id}: logits {r.result.shape}, finite {np.isfinite(r.result).all()}")
    check(forwards == len(engine.buckets) + engine.stats.batches,
          f"{forwards} forwards vs {len(engine.buckets)} warmup + {engine.stats.batches} batches")
    check(launches == model.depth * forwards,
          f"flash kernel launched {launches} times in {forwards} forwards "
          f"(expected {model.depth} per forward)")
    check(engine.stats.check_invariants() == [], str(engine.stats.check_invariants()))
    phase_sums = {p: h.sum * 1e3 for p, h in engine.stats.phases.items()}
    print(f"[serve] flash: {len(done)} requests in {engine.stats.batches} batches "
          f"(occupancy {scalars['serve.batch_occupancy']:.3f}), "
          f"{scalars['serve.requests_per_s']} requests/s, latency p50 <= "
          f"{scalars['serve.latency_p50_ms']} ms, p99 <= {scalars['serve.latency_p99_ms']} ms "
          f"(bucket upper bounds), mean {engine.stats.total.sum / len(done) * 1e3:.3f} ms")
    print("[serve] flash: phase sums over requests (ms): "
          + ", ".join(f"{p} {v:.3f}" for p, v in phase_sums.items()))
    print(f"[serve] flash: {launches} kernel launches in {forwards} forwards")

    flash_logits = {r.id: r.result for r in done}
    model.attn_impl = "xla"
    fa.flash_fwd.launches = 0
    _, done_xla, scalars_xla = _serve(model, payloads)
    check(fa.flash_fwd.launches == 0, "the xla run launched the flash kernel")
    check(len(done_xla) == SERVE_REQUESTS and all(r.ok for r in done_xla),
          "the xla run did not complete every request")
    worst = 0.0
    for r in done_xla:
        ref, got = r.result, flash_logits[r.id]
        worst = max(worst, float(np.abs(got - ref).max()))
        check(bool(np.all(np.abs(got - ref) <= LOGITS_TOL[0] + LOGITS_TOL[1] * np.abs(ref))),
              f"request {r.id}: flash vs xla logits differ by {np.abs(got - ref).max():.3g}")
    print(f"[serve] xla: {scalars_xla['serve.requests_per_s']} requests/s, latency p50 <= "
          f"{scalars_xla['serve.latency_p50_ms']} ms, p99 <= "
          f"{scalars_xla['serve.latency_p99_ms']} ms")
    print(f"[serve] logits flash vs xla: max |diff| {worst:.3g} "
          f"(tolerance {LOGITS_TOL[0]} + {LOGITS_TOL[1]} * |xla|)")

    _forward_split(model, payloads[:SERVE_MAX_BATCH])
    return {"flash_attention_fwd": launches}


# -- main --------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke run needs one "
              "card", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    phase_build()
    measured = phase_kernels()
    launches = phase_serve()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kernels = [
        {"name": name, **KERNELS[name], "launches": launches[name], **measured[name]}
        for name in KERNELS
    ]
    for k in kernels:
        check(all(isinstance(k[key], (int, float)) and math.isfinite(k[key])
                  for key in ("max_abs_err", "ms", "plain_ms", "bound_ms")),
              f"{k['name']}: a measurement is missing")
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
