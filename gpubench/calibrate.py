"""The readings that the limits of ``correct`` are set from, for one cell,
over many seeds in one process (the benchmark's own runs never run this).

From the root of a checkout, on the card::

    python3 gpubench/calibrate.py --workload vit_b16.i224_b256 --seeds 1-12 \\
        --sides program control half_batch

Each seed builds the program from the seed and runs its compared steps
exactly as a run's set-up does, then runs the float32 reference once, and
prints one JSON line a side with the numbers of :mod:`gpubench.check`:

* ``program``: the program as the configuration states it (the lower
  readings);
* ``control``: the reference in the program's place at the precision below
  the configuration's (fp8 for bfloat16; :mod:`gpubench.reference`);
* ``half_batch``: the program with half of each batch left out of the loss,
  the mean taken over the rest (a planted fault);
* ``unchanged``: the program with an optimizer that leaves the state as it
  is (a planted fault; it reads 1 by construction);
* ``program_f32``: the program with its compute dtype set to float32 and
  TF32 off (cuDNN's convolutions default to it), the second witness that
  the layers are the reference's;
* ``reference_bf16``: the reference with its products' operands rounded
  to bfloat16, a witness of the gaps that bf16 rounding alone makes;
* ``control_operands``: the reference with its convolutions' and linear
  layers' operands in fp8 and its activations in float32 (the control
  without its rounded activations);
* ``reference_jitter``: the float32 reference from its weights each scaled
  by ``1 + 1e-6·N(0, 1)``, a witness of how far the compared steps carry a
  rounding-sized change with no lower precision anywhere.

Beside the numbers, each line names the three leaves with the largest
gradient gap and the three with the largest change gap, with their gaps.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gpubench import check  # noqa: E402
from gpubench.manifest import Manifest  # noqa: E402
from gpubench.reference.layers import full_float32  # noqa: E402
from gpubench.run import reference_record  # noqa: E402

SIDES = ("program", "control", "half_batch", "unchanged", "program_f32", "reference_bf16",
         "control_operands", "reference_jitter")
#: The reference's sides: their precision and weight jitter.
REFERENCE_SIDES = {"control": ("fp8", 0.0), "reference_bf16": ("bf16", 0.0),
                   "control_operands": ("fp8_operands", 0.0), "reference_jitter": ("f32", 1e-6)}


@contextlib.contextmanager
def fault(name: str):
    """The program with the planted fault ``name`` (or none)."""
    if name == "half_batch":
        import tpu_dist_torch.nn.functional as F  # noqa: PLC0415, N812

        whole = F.cross_entropy

        def half(logits, labels, **kw):
            n = max(1, len(labels) // 2)
            return whole(logits[:n], labels[:n], **kw)

        F.cross_entropy = half
        try:
            yield
        finally:
            F.cross_entropy = whole
    elif name == "unchanged":
        from tpu_dist_torch.train import optim  # noqa: PLC0415

        update = optim.SGD.update
        optim.SGD.update = lambda self, grads, opt_state, params, lr: (params, opt_state)
        try:
            yield
        finally:
            optim.SGD.update = update
    else:
        yield


def program_record(man: Manifest, cell: dict, seed: int, device, side: str) -> dict:
    cfg, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    if side == "program_f32":
        cfg["compute_dtype"] = "float32"
    model, entry = man.model(cell["config"]), man.entry(traffic["entry"])
    exact = full_float32() if side == "program_f32" else contextlib.nullcontext()
    with fault(side), exact:
        system = entry.System(model, cfg, traffic, seed, device)
        try:
            return system.first_steps(traffic["check_steps"])
        finally:
            system.close()
            del system
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()


def worst_leaves(rec: dict, ref: dict, k: int = 3) -> dict:
    """The ``k`` leaves with the largest gradient gap and change gap."""
    grads = check.leaf_gaps(rec["grad_norms"], ref["grad_norms"], list(ref["grad_norms"]))
    deltas = check.leaf_gaps(rec["delta_norms"], ref["delta_norms"], check.moving_leaves(ref))
    return {key: [[n, round(gaps[n], 5)] for n in sorted(gaps, key=gaps.get, reverse=True)[:k]]
            for key, gaps in (("worst_grad_leaves", grads), ("worst_update_leaves", deltas))}


def seeds(spec: str) -> list:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,9")
    p.add_argument("--sides", nargs="+", default=["program"], choices=SIDES)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    man = Manifest(ROOT)
    cell = man.workload(args.workload)
    cfg, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    model, entry = man.model(cell["config"]), man.entry(traffic["entry"])
    for seed in seeds(args.seeds):
        records = {}
        for side in args.sides:
            if side not in REFERENCE_SIDES:
                records[side] = program_record(man, cell, seed, args.device, side)
        t0 = time.perf_counter()
        ref = reference_record(model, entry, cfg, traffic, seed, args.device)
        ref_s = time.perf_counter() - t0
        for side, (precision, jitter) in REFERENCE_SIDES.items():
            if side in args.sides:
                records[side] = reference_record(model, entry, cfg, traffic, seed, args.device,
                                                 precision=precision, jitter=jitter)
        for side, rec in records.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              **check.compare(rec, ref), "losses": rec["losses"],
                              "ref_losses": ref["losses"], "reference_s": ref_s,
                              **worst_leaves(rec, ref)}), flush=True)
        gc.collect()
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
