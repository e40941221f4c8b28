"""Device and host times of the fused SGD kernel (``ops/fused_sgd.py``)
against ``torch.optim.SGD(fused=True).step()`` at the leaves of the port's
two training paths, on one card::

    python -m tpu_dist_torch.obs.fused_sgd_bench            # kernel and library
    python -m tpu_dist_torch.obs.fused_sgd_bench --sweep    # and the kernel's sizes

ResNet-18 (62 leaves, 11,220,132 f32 parameters) and ViT-B/16 (151 leaves,
86,566,120). At each, the kernel and the library are timed in turns
(kernel, library, library, kernel). Device times come from the head-start
timer of ``obs/timing.py`` (the device sleeps until the host has enqueued
every call), host times from the host clock around calls with no
synchronise. ``torch.profiler`` reads the kernel's own duration once as a
cross-check, and counts host-to-device copies; ``miss_us`` is the host
time of building a plan (``make_plan``), which a call pays when its leaves
have moved. ``--sweep`` rebuilds ``csrc/fused_sgd.cu`` with other tile
sizes, CTAs a streaming multiprocessor and table sizes (``-D`` defines),
checks each build bit for bit against the plain version, and times each
twice, in the list's order and then back. Prints one JSON object as its
last line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys

import torch

from tpu_dist_torch.comm import compat
from tpu_dist_torch.obs import timing
from tpu_dist_torch.ops import _build
from tpu_dist_torch.ops import fused_sgd as fs

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SHAPES = {"resnet18": (62, 11_220_132), "vit_b16": (151, 86_566_120)}  # leaves, parameters
# (float4 a thread a tile, CTAs a SM, leaves a table) of each --sweep build;
# the kernel as built by default is (4, 6, 768)
SWEEP = ([(vec, ctas, 768) for vec in (1, 2, 4) for ctas in (2, 3, 4, 6, 8)]
         + [(4, 6, 64), (4, 6, 256)])


def leaf_shapes(model: str) -> list:
    """The parameter shapes of ``model``."""
    if model == "resnet18":
        from tpu_dist_torch.nn.resnet import resnet18  # noqa: PLC0415
        net = resnet18(device="meta")
    else:
        from tpu_dist_torch.nn.vit import vit_b16  # noqa: PLC0415
        net = vit_b16(device="meta")
    shapes = [p.shape for p in net.parameters()]
    n = sum(s.numel() for s in shapes)
    if (len(shapes), n) != SHAPES[model]:
        raise RuntimeError(f"{model}: {len(shapes)} leaves, {n} parameters")
    return shapes


def sgd_bound_ms(n: int) -> float:
    """p, g, b read once and p, b written once: 20 bytes a parameter over
    HBM's rate (its 6 operations take 11x less at the f32 peak)."""
    return 20 * n / PEAK_BYTES_PER_S * 1e3


def _leaves(shapes, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = [torch.randn(s, device="cuda", generator=gen) for s in shapes]
    grads = [torch.randn(s, device="cuda", generator=gen) for s in shapes]
    return params, grads, [torch.zeros_like(p) for p in params]


# torch.profiler sessions of CUDA activity alone now and then record no kernel
# at all in a process that has run others (PERF.md §7): a session that holds
# no fused SGD kernel is taken again, at most this many in all
PROFILER_SESSIONS = 3


def measure(ops, shapes, seed: int = 0, iters: int = 50, lr: float = 0.1) -> dict:
    """``ops.fused_sgd`` (``ops``: the fused SGD module) and the library at
    one set of leaves, in turns; device ms and host us of each turn, the
    profiler's mean kernel ms and the number of host-to-device copies in 10
    profiled kernel calls (``profiler_sessions``: the sessions it took to
    record the kernel), and the host us of a plan cache miss where the
    module plans."""
    params, grads, bufs = _leaves(shapes, seed)
    lr_t = torch.full((), lr, device="cuda")
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    lib = torch.optim.SGD(lib_params, lr=lr, momentum=0.9, weight_decay=1e-4, fused=True)

    def kernel():
        ops.fused_sgd(params, grads, bufs, lr_t)

    out = {"ms": [], "host_us": [], "library_ms": [], "library_host_us": []}
    for which in ("kernel", "library", "library", "kernel"):
        ms, us = timing.device_ms(kernel if which == "kernel" else lib.step, iters=iters)
        prefix = "" if which == "kernel" else "library_"
        out[prefix + "ms"].append(ms)
        out[prefix + "host_us"].append(us)
    for session in range(1, PROFILER_SESSIONS + 1):
        rows = timing.profile_device(kernel, iters=10)
        own = [(c, us) for k, (c, us) in rows.items() if "fused_sgd" in k]
        if own:
            break
    out["profiler_sessions"] = session
    out["profiler_ms"] = (sum(us for _, us in own) / max(sum(c for c, _ in own), 1) / 1e3
                          if own else None)
    out["profiler_kernels"] = sorted(k for k in rows if "fused_sgd" in k)
    out["htod_copies"] = sum(c for k, (c, _) in rows.items() if "HtoD" in k)
    out["miss_us"] = (timing.host_us(lambda: ops.make_plan(params, grads, bufs), iters=20)
                      if hasattr(ops, "make_plan") else None)
    n = sum(s.numel() for s in shapes)
    out.update(leaves=len(shapes), params=n, bound_ms=sgd_bound_ms(n))
    return out


def _defines(vec: int, ctas: int, cap: int) -> tuple:
    return (f"FUSED_SGD_VEC={vec}", f"FUSED_SGD_CTAS_PER_SM={ctas}",
            f"FUSED_SGD_MAX_LEAVES={cap}")


def sweep(shapes, seed: int = 0, iters: int = 50) -> dict:
    """``{"vec x ctas x cap": [(device ms, host us), ...]}``: every build of
    :data:`SWEEP` whose table holds these leaves, checked bit for bit over
    one step, then timed twice (the list forward, then back)."""
    variants = [v for v in SWEEP if v[2] >= len(shapes)]
    with concurrent.futures.ThreadPoolExecutor(8) as ex:  # nvcc, one process a build
        list(ex.map(lambda v: _build.build("fused_sgd", _defines(*v)), variants))
    fns = {v: _build.bind("fused_sgd", "tpu_dist_fused_sgd", fs.ARGTYPES, _defines(*v))
           for v in variants}
    lr = torch.full((), 0.1, device="cuda")
    stream = compat.current_raw_stream(0)

    def call(v, leaves):
        plan = fs.make_plan(*leaves, tile=1024 * v[0], max_leaves=v[2])

        def run():
            for one in plan.launches:
                err = fns[v](one.address, len(one.leaves), lr.data_ptr(), 0.0, 0.9, 1e-4, 0,
                             stream)
                if err:
                    raise RuntimeError(f"fused_sgd {v}: CUDA error {err}")
        return run

    params, grads, bufs = _leaves(shapes, seed)
    for v in variants:
        mine = ([p.clone() for p in params], grads, [b.clone() for b in bufs])
        ref = ([p.clone() for p in params], grads, [b.clone() for b in bufs])
        call(v, mine)()
        fs.fused_sgd_reference(*ref, lr)
        if not all(torch.equal(a, b) for a, b in zip(mine[0] + mine[2], ref[0] + ref[2])):
            raise RuntimeError(f"fused_sgd built as {v} differs from its plain version")
        del mine, ref
    out = {}
    for v in variants + variants[::-1]:
        out.setdefault(" x ".join(map(str, v)), []).append(
            timing.device_ms(call(v, (params, grads, bufs)), iters=iters))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time the kernel built with other tile, CTA and table sizes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_sgd_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = {model: measure(fs, leaf_shapes(model)) for model in SHAPES}
    for model, m in result.items():
        print(f"[sgd_bench] {model}: kernel {m['ms']} ms, host {m['host_us']} us; library "
              f"{m['library_ms']} ms, host {m['library_host_us']} us; profiler "
              f"{m['profiler_ms']} ms {m['profiler_kernels']}; HtoD copies in 10 calls "
              f"{m['htod_copies']}; a plan cache miss {m['miss_us']} us; bound "
              f"{m['bound_ms']:.4f} ms")
    if args.sweep:
        for model in SHAPES:
            result[model]["sweep"] = sweep(leaf_shapes(model))
            print(f"[sgd_bench] {model}, device ms and host us by float4 a thread x CTAs a SM "
                  f"x leaves a table: " + "; ".join(
                      f"{k} " + ", ".join(f"{ms:.4f} ms {us:.1f} us" for ms, us in runs)
                      for k, runs in result[model]["sweep"].items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
