"""Sets of runs of one cell, and the spreads that its bounds are set from.

From the root of a checkout, on the card::

    python3 gpubench/spread.py --workload vit_b16.i224_b256 --seeds 11-16 --sets 2 \\
        --out runs/vit_b16.i224_b256.jsonl

runs the benchmark's command once per seed in each set (the same seeds in
every set, each run a process of its own, one after another), appends each
result line to ``--out`` and prints, for each metric, each set's median and
spread (the quartiles' distance over the median, :func:`gpubench.stats.
spread`), and five times the widest spread: the bound it suggests (never
under 1%). ``setup_s`` leaves out the first run of all, which builds the
kernels.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import stats  # noqa: E402
from gpubench.calibrate import seeds as parse_seeds  # noqa: E402


def one_run(workload: str, seed: int, seconds: int, trace: int) -> dict:
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "gpubench/run.py"), "--workload", workload,
                          "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=1200)
    rec = {"workload": workload, "seed": seed, "trace": trace, "rc": out.returncode,
           "wall_s": time.perf_counter() - t0, "stderr_tail": out.stderr[-1500:]}
    lines = out.stdout.strip().splitlines()
    if out.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--seconds", type=int)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    values: dict = {}
    first = True
    for s in range(args.sets):
        for seed in parse_seeds(args.seeds):
            rec = dict(one_run(args.workload, seed, seconds, args.trace), set=s)
            with out.open("a") as f:
                f.write(json.dumps(rec) + "\n")
            res = rec.get("result")
            print(json.dumps({k: rec[k] for k in ("set", "seed", "rc", "wall_s")}
                             | ({"correct": res["correct"],
                                 **{m: v["value"] for m, v in res["metrics"].items()},
                                 **{c: v["value"] for c, v in res["checks"].items()}}
                                if res else {"stderr": rec["stderr_tail"][-600:]})), flush=True)
            if res:
                for m, v in res["metrics"].items():
                    if not (m == "setup_s" and first):
                        values.setdefault(m, {}).setdefault(s, []).append(v["value"])
            first = False
    for m, by_set in values.items():
        rows = {s: (statistics.median(v), stats.spread(v) if len(v) >= 2 else float("nan"))
                for s, v in by_set.items()}
        widest = max(sp for _, sp in rows.values())
        print(json.dumps({"metric": m, "sets": rows, "widest_spread": widest,
                          "bound_5x": max(0.01, 5 * widest)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
