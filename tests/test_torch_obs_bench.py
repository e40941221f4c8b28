"""The port's bench mode of the run-compare gate (``tpu_dist_torch/obs/
compare.py``: ``compare_bench``, ``bench_report``, ``compare_files(...,
bench=True)``; ``python -m tpu_dist_torch.obs compare --bench`` and
``summarize --bench``) held against the JAX package's on the same files.

The bench files are ``bench.py``'s line schema (one JSON object a line),
written here from a numpy seed: a training, a checkpoint and a serving
record that carry every ``BENCH_FIELDS`` field between them, each stamped
with a capture fingerprint. The candidates are a fresh capture of the same
numbers, a 20% throughput drop, a ``step_ms_p99`` rise, an improvement, a
metric on one side only, a re-emitted capture, a self-declared ``stale:
true``, a torn last line, a file with no bench record and an absent one;
the repo's own ``LAST_GOOD_BENCH.json`` and ``BENCH_r05.json`` are read
too. Every check compares the result dicts for equality, and the CLI's
stdout, stderr and exit code byte for byte once the port's program name
is swapped for JAX's. All comparisons are exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_ranks import child_env

from tpu_dist.obs import __main__ as jax_obs
from tpu_dist.obs import compare as jax_compare
from tpu_dist_torch.obs import __main__ as obs
from tpu_dist_torch.obs import compare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_FILES = {"last_good": os.path.join(ROOT, "LAST_GOOD_BENCH.json"),
              "r05": os.path.join(ROOT, "BENCH_r05.json")}
TRAIN, CKPT, SERVE = ("resnet18_cifar100_train_throughput", "sharded_ckpt_async",
                      "serve_vit_b16_throughput")


def _base_records(seed: int = 0) -> list:
    """Three records, every ``BENCH_FIELDS`` field among them, from ``seed``."""
    rng = np.random.default_rng(seed)

    def draw(lo, hi, nd=2):
        return round(float(rng.uniform(lo, hi)), nd)

    step = draw(60.0, 120.0)
    train = {"metric": TRAIN, "value": draw(2000.0, 4000.0, 1), "unit": "images/sec",
             "sec_per_epoch": draw(15.0, 25.0), "step_ms": step, "step_ms_p50": step,
             "step_ms_p95": round(step * 1.1, 2), "step_ms_p99": round(step * 1.3, 2),
             "mfu": draw(0.2, 0.5, 4), "peak_hbm_bytes": int(rng.integers(1 << 30, 4 << 30)),
             "hlo_wire_bytes_per_step": int(rng.integers(1 << 20, 1 << 26)),
             "planner_error_frac": draw(0.0, 0.1, 4), "goodput_frac": draw(0.7, 0.95, 4)}
    ckpt = {"metric": CKPT, "value": draw(10.0, 50.0), "unit": "ms blocked per save",
            "ckpt_blocked_ms": draw(10.0, 50.0)}
    serve = {"metric": SERVE, "value": draw(300.0, 600.0, 1), "unit": "requests/sec",
             "requests_per_s": draw(300.0, 600.0, 1), "latency_p50_ms": draw(2.0, 6.0),
             "latency_p99_ms": draw(8.0, 20.0), "batch_occupancy": draw(0.4, 0.9, 3)}
    return [train, ckpt, serve]


def _stamp(recs: list, run_id: str) -> list:
    return [{**r, "capture": {"host": "benchhost", "bench_run_id": run_id, "mono_s": 10.0 + i}}
            for i, r in enumerate(recs)]


def _edit(recs: list, metric: str, **fields) -> list:
    return [{**r, **fields} if r["metric"] == metric else r for r in recs]


def _write(path, recs: list, tail: str = "") -> str:
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
        f.write(tail)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    plain = _base_records()
    base = _stamp(plain, "base000001")
    fresh = _stamp(plain, "cand000001")
    tr = next(r for r in plain if r["metric"] == TRAIN)
    out = dict(REPO_FILES)
    for name, recs in {
        "base": base,
        "plain": plain,
        "fresh": fresh,
        "slower": _edit(fresh, TRAIN, value=round(tr["value"] * 0.8, 1)),
        "p99_up": _edit(fresh, TRAIN, step_ms_p99=round(tr["step_ms_p99"] * 1.25, 2)),
        "better": _stamp([
            {**r, **{k: round(v * (1.2 if k in ("value", "mfu", "requests_per_s",
                                                "goodput_frac", "batch_occupancy") else 0.8), 4)
                     for k, v in r.items() if isinstance(v, float)}} for r in plain],
            "cand000002"),
        "one_side": fresh[:2] + _stamp([{"metric": "only_in_cand", "value": 1.0}], "cand000003"),
        "reemit": [base[0]] + fresh[1:],
        "self_stale": _edit(fresh, TRAIN, stale=True, age_days=3),
        "dup": base + [{**base[0], "metric": TRAIN + "_again"},
                       {"metric": "legacy", "value": 1.0},
                       {**fresh[2], "metric": "fallback", "stale": True, "age_days": 30}],
    }.items():
        out[name] = _write(d / f"{name}.jsonl", recs)
    out["torn"] = _write(d / "torn.jsonl", fresh[:2], tail='{"metric": "' + SERVE + '", "val')
    out["no_bench"] = _write(d / "no_bench.jsonl", [{"kind": "train_epoch", "epoch": 0}])
    out["absent"] = str(d / "absent.jsonl")
    return out


def _both(capsys, argv: list) -> tuple:
    """``argv`` through the port's and JAX's ``obs`` CLI: (rc, stdout,
    stderr) of each, the port's program name swapped for JAX's."""
    out = []
    for main in (obs.main, jax_obs.main):
        capsys.readouterr()
        rc = main(list(argv))
        o, e = capsys.readouterr()
        out.append((rc, o, e.replace("tpu_dist_torch.obs", "tpu_dist.obs")))
    return tuple(out)


def test_bench_fields_are_jax():
    assert compare.BENCH_FIELDS == jax_compare.BENCH_FIELDS
    got = {f for f, _, _ in compare.BENCH_FIELDS}
    # the module's records carry every field the gate reads
    assert got <= {k for r in _base_records() for k in r}


@pytest.mark.parametrize("field,direction,slack", jax_compare.BENCH_FIELDS)
def test_each_bench_field_gates_as_jax(field, direction, slack):
    """A 20% move the wrong way regresses, the same move the right way is
    never flagged, and both results are JAX's. The baseline is large enough
    that 20% of it clears the field's absolute slack (1 MiB for
    ``peak_hbm_bytes``)."""
    x = max(100.0, 100.0 * slack)
    worse, better = (0.8 * x, 1.2 * x) if direction == "higher" else (1.2 * x, 0.8 * x)
    for cand, verdict in ((worse, "REGRESSED"), (better, "ok"), (x, "ok")):
        b, c = {"m": {"metric": "m", field: x}}, {"m": {"metric": "m", field: cand}}
        got = compare.compare_bench(b, c, threshold=0.05)
        assert got == jax_compare.compare_bench(b, c, threshold=0.05)
        (row,) = got["rows"]
        assert row["metric"] == f"m.{field}" and row["verdict"] == verdict


# (candidate, the exit code the gate's purpose fixes, a verdict that must
# show in the rows); the baseline is "base" unless the pair names one
PAIRS = [
    ("plain", "plain", 0, None),            # a self-compare of unstamped records
    ("base", "fresh", 0, None),             # the same numbers, a fresh capture
    ("base", "base", 2, "STALE"),           # one capture on both sides: nothing compared
    ("base", "slower", 1, "REGRESSED"),     # 20% less throughput
    ("base", "p99_up", 1, "REGRESSED"),     # step_ms_p99 up 25%
    ("base", "better", 0, None),            # an improvement is never flagged
    ("slower", "base", 0, None),
    ("base", "one_side", 0, "skipped"),
    ("base", "reemit", 0, "STALE"),
    ("base", "self_stale", 0, "STALE"),
    ("base", "torn", 0, "skipped"),
    ("base", "no_bench", 2, None),
    ("no_bench", "base", 2, None),
    ("base", "absent", 2, None),
    ("last_good", "last_good", 0, None),
    ("last_good", "base", 1, "REGRESSED"),  # the TPU record against the seed's numbers
    ("r05", "last_good", 2, None),
]


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("base,cand,rc,verdict", PAIRS)
def test_compare_bench_cli_equals_jax(files, capsys, base, cand, rc, verdict, fmt):
    argv = ["compare", files[base], files[cand], "--bench", "--format", fmt]
    ours, theirs = _both(capsys, argv)
    assert ours == theirs
    assert ours[0] == rc
    if verdict:
        assert verdict in ours[1]


@pytest.mark.parametrize("base,cand", [(p[0], p[1]) for p in PAIRS
                                       if p[2] != 2 or p[3] == "STALE"])
def test_compare_files_bench_equals_jax(files, base, cand):
    got = compare.compare_files(files[base], files[cand], bench=True)
    assert got == jax_compare.compare_files(files[base], files[cand], bench=True)
    b, c = compare.load_bench_records(files[base]), compare.load_bench_records(files[cand])
    assert (b, c) == (jax_compare.load_bench_records(files[base]),
                      jax_compare.load_bench_records(files[cand]))


def test_the_planted_moves_read_as_jax_reads_them(files):
    def rows(cand):
        return {r["metric"]: r for r in
                compare.compare_files(files["base"], files[cand], bench=True)["rows"]}

    slow = rows("slower")
    assert slow[f"{TRAIN}.value"]["verdict"] == "REGRESSED"
    assert slow[f"{TRAIN}.value"]["delta_frac"] == pytest.approx(-0.2, abs=1e-3)
    assert [m for m, r in slow.items() if r["verdict"] == "REGRESSED"] == [f"{TRAIN}.value"]
    assert [m for m, r in rows("p99_up").items()
            if r["verdict"] == "REGRESSED"] == [f"{TRAIN}.step_ms_p99"]
    assert not [m for m, r in rows("better").items() if r["verdict"] != "ok"]
    one = rows("one_side")
    assert one[SERVE]["verdict"] == one["only_in_cand"]["verdict"] == "skipped"
    assert (one[SERVE]["baseline"], one["only_in_cand"]["candidate"]) == ("present", "present")
    res = compare.compare_files(files["base"], files["reemit"], bench=True)
    assert res["stale"] == 1 and rows("reemit")[TRAIN]["candidate"] == "same capture"
    assert rows("self_stale")[TRAIN]["candidate"] == "stale capture"
    assert rows("torn")[SERVE]["candidate"] is None
    same = compare.compare_files(files["base"], files["base"], bench=True)
    assert same["stale"] == 3 and same["compared"] == 0


@pytest.mark.parametrize("flag", ["--goodput", "--slo"])
def test_bench_with_a_history_gate_is_a_broken_call(files, capsys, flag):
    argv = ["compare", files["base"], files["fresh"], "--bench", flag]
    ours, theirs = _both(capsys, argv)
    assert ours == theirs and ours[0] == 2
    assert "--goodput/--slo gate history-mode logs" in ours[2]
    with pytest.raises(ValueError, match="history-mode"):
        compare.compare_files(files["base"], files["fresh"], bench=True, goodput_only=True)


SUMMARIZE = {"base": 0, "dup": 0, "self_stale": 0, "torn": 0, "last_good": 0,
             "no_bench": 1, "r05": 1, "absent": 2}


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("name", sorted(SUMMARIZE))
def test_summarize_bench_cli_equals_jax(files, capsys, name, fmt):
    ours, theirs = _both(capsys, ["summarize", files[name], "--bench", "--format", fmt])
    assert ours == theirs
    assert ours[0] == SUMMARIZE[name]


@pytest.mark.parametrize("name", [n for n, rc in sorted(SUMMARIZE.items()) if rc == 0])
def test_bench_report_equals_jax(files, name):
    got = compare.bench_report(files[name])
    assert got == jax_compare.bench_report(files[name])
    assert compare.format_bench_report(got) == jax_compare.format_bench_report(got)


def test_the_report_flags_reemitted_and_self_declared_captures(files):
    rep = compare.bench_report(files["dup"])
    by = {r["metric"]: r for r in rep["records"]}
    assert by[TRAIN + "_again"]["stale_of"] == TRAIN and by["fallback"]["stale"]
    assert "capture" not in by["legacy"]
    assert (rep["n_stale"], rep["n_unfingerprinted"]) == (2, 1)
    text = compare.format_bench_report(rep)
    assert f"re-emits {TRAIN}" in text and "(30d old)" in text and "2 STALE" in text
    assert compare.bench_report(files["last_good"])["n_unfingerprinted"] == 1
    with pytest.raises(ValueError, match="no bench records"):
        compare.bench_report(files["r05"])


def test_the_bench_cli_runs_as_a_module(files):
    proc = subprocess.run([sys.executable, "-m", "tpu_dist_torch.obs", "compare",
                           files["base"], files["slower"], "--bench"], cwd=ROOT,
                          env=child_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and f"{TRAIN}.value" in proc.stdout
