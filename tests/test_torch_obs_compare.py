"""The port's history summary (``tpu_dist_torch/obs/summarize.py::summarize``)
and run-compare gate (``tpu_dist_torch/obs/compare.py``, ``python -m
tpu_dist_torch.obs compare``) held against the JAX package's.

Histories of both packages go through both ``summarize``s and must give
the same report: a training run of the port's ``Trainer``, serving runs of
the port's drill replays, the JAX package's TPU run history in the repo
(``TPU_RUN_r02_history.jsonl``), and one history of every record kind the
summary folds (goodput windows across a resumed segment, resume, alert,
anomaly, device_stats, memory and OOM, plan, tune, postmortem, serve
windows and events, profile analyses, fleet and tenancy records) written
once by each package's ``MetricsHistory``. The compare CLI gives the JAX
CLI's rows, text, JSON and exit codes on the same file pairs, with and
without ``--slo``/``--goodput``/``--threshold``; ``--bench``,
``--against-archive`` and the subcommands the port lacks exit 2 naming
their ROADMAP item. All comparisons are exact.
"""

import json
import os
import subprocess
import sys

import pytest
from torch_ranks import child_env, fit_run, free_port

from tpu_dist.metrics.history import MetricsHistory as JaxHistory
from tpu_dist.obs import __main__ as jax_obs
from tpu_dist.obs import compare as jax_compare
from tpu_dist.obs import counters as jax_counters
from tpu_dist.obs import summarize as jax_summ
from tpu_dist_torch.metrics.history import MetricsHistory
from tpu_dist_torch.obs import __main__ as obs
from tpu_dist_torch.obs import compare, counters
from tpu_dist_torch.obs import summarize as summ
from tpu_dist_torch.serve import drill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_RUN = os.path.join(ROOT, "TPU_RUN_r02_history.jsonl")


def _kitchen_sink(history_cls, path):
    """One history of every kind the summary folds, two segments."""
    h = history_cls(path, run_id="seg-1")
    cnt = {"train.steps": 3, "ckpt.writes": 1, "compile.retraces": 0,
           "mem.peak_bytes_in_use": 5 << 20}
    for epoch in range(2):
        cnt = {**cnt, "train.steps": cnt["train.steps"] + 3,
               "compile.retraces": epoch, "mem.peak_bytes_in_use": (6 + epoch) << 20}
        h.log("device_stats", epoch=epoch, step=1, grad_norm=1.5 + epoch, update_ratio=0.01,
              param_norm=30.0, counters={})
        h.log("train_epoch", epoch=epoch, loss=2.0 - epoch * 0.5, epoch_time=10.0 + epoch,
              images_per_sec=1000.0 + epoch, step_time_p50=0.05, step_time_p95=0.06,
              step_time_p99=0.07, data_stall_frac=0.1, mfu=0.3, counters=cnt)
        h.log("eval", epoch=epoch, top1=40.0 + epoch, top5=80.0, loss=1.5)
        h.log("goodput", epoch=epoch, window_s=12.0, productive_s=9.0, compile_s=1.0,
              ckpt_s=0.5, data_stall_s=0.5, eval_s=0.5, preempt_s=0.0,
              preempt_for_serve_s=0.0, recovery_s=0.0, unattributed_s=0.5, counters={})
    h.log("alert", epoch=1, rule="stall_high", metric="train.data_stall_frac", value=0.4,
          threshold=0.25, op=">", sustained=2, counters={})
    h.log("anomaly", epoch=1, step=2, anomaly="loss_spike", value=9.0, median=2.0, ratio=4.5,
          counters={})
    h.log("straggler", epoch=1, skew=1.4, worst_rank=1, max_s=1.4, median_s=1.0, counters={})
    h.log("memory", epoch=0, static={"bytes_per_device": 1 << 20},
          allocator={"peak_bytes_in_use": 9 << 20}, counters={})
    h.log("memory", event="oom", epoch=1, oom={"kind": "oom", "requested_bytes": 4},
          ledger={}, counters={})
    h.log("plan", epoch=0, family="dp", mode="plan", predicted_step_s=0.05,
          achieved_step_s=0.055, planner_error_frac=0.09, counters={})
    h.log("tune", epoch=0, family="dp", objective="step", applied={"a": 1}, counters={})
    h.log("profile", epoch=1, event="stop", reason="retrace", steps=3, counters={})
    h.log("profile_analysis", epoch=1, overlap_frac=0.6, collective_frac=0.2,
          device_busy_s=1.0, counters={})
    h.log("postmortem", n_ranks=1, verdicts={"0": "preempted"}, counters={})
    h.log("fleet", tick=3, action="grant", recipient="a", chips=2, counters={})
    h.log("tenancy", tick=3, alloc={"a": 2, "b": 2}, free=0, pending=0, total_chips=4,
          counters={})
    h.log("serve", window_s=1.0, requests=10, completed=10, requests_per_s=10.0,
          latency_p50_ms=6.4, latency_p99_ms=12.8, ttfb_p99_ms=6.4, availability=1.0,
          batch_occupancy=0.5, queue_depth=0, queue_depth_max=3, counters={})
    h.log("serve", event="retrace", bucket=4, n_real=3, counters={})
    h.log("goodput", final=True, window_s=24.0, productive_s=18.0, elapsed_s=24.0,
          counters={})
    h.log("from_the_future", epoch=9, counters={})
    h.close()
    h = history_cls(path, run_id="seg-2")
    h.log("resume", epoch=1, world=2, dp=2, prev_dp=4, resharded=True, restarts=1, counters={})
    h.log("train_epoch", epoch=2, loss=1.0, epoch_time=10.0, images_per_sec=900.0,
          counters={"train.steps": 3})
    h.log("goodput", epoch=2, window_s=11.0, productive_s=8.0, recovery_s=1.0, counters={})
    h.close()


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("logs")
    out = {"tpu_run": TPU_RUN}
    # a history stamps the registry's counters on a record that has none:
    # start from empty registries, whatever ran in this process before
    counters.reset()
    jax_counters.reset()
    for name, cls in (("sink_port", MetricsHistory), ("sink_jax", JaxHistory)):
        out[name] = str(d / f"{name}.jsonl")
        _kitchen_sink(cls, out[name])
    out["train"] = str(d / "train.jsonl")
    fit_run(dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=96,
                 batch_size=16, epochs=2, steps_per_epoch=2, lr=0.02, log_every=1,
                 eval_every=1, seed=0, device="cpu", port=free_port(),
                 log_file=out["train"]))
    model = drill._drill_model("cpu")
    w = drill.write_training_ckpt(str(d / "ck"), model)
    for name, step in (("base", drill.BASE_STEP_S), ("reg", drill.REGRESSED_STEP_S),
                       ("imp", drill.IMPROVED_STEP_S)):
        out[name] = drill.replay(str(d), name, model, w, auto_step_s=step,
                                 device="cpu")["log"]
    # a slower, lossier copy of the training run, for the default gate
    with open(out["train"]) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        if r["kind"] == "train_epoch":
            r["images_per_sec"] *= 0.5
            r["loss"] += 1.0
    out["train_slow"] = str(d / "train_slow.jsonl")
    with open(out["train_slow"], "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    out["empty"] = str(d / "empty.jsonl")
    open(out["empty"], "w").close()
    counters.reset()
    jax_counters.reset()
    return out


@pytest.mark.parametrize("name", ["tpu_run", "sink_port", "sink_jax", "train", "base", "reg"])
def test_summarize_equals_jax(logs, name):
    records, bad = summ.load_records(logs[name])
    assert (records, bad) == jax_summ.load_records(logs[name])
    ours = summ.summarize(records, bad)
    assert ours == jax_summ.summarize(records, bad)
    assert compare.report_scalars(ours) == jax_compare.report_scalars(ours)
    if name.startswith("sink"):
        assert ours["tenancy"]["conserved"] and ours["goodput"]["n_segments"] == 2
        assert ours["skipped_kinds"] == {"from_the_future": 1}
        assert ours["memory"]["peak_hbm_bytes"] == 9 << 20


def test_the_kitchen_sink_reads_alike_from_either_writer(logs):
    drop = ("ts", "rel_s")

    def recs(path):
        return [{k: v for k, v in r.items() if k not in drop} for r in summ.load_records(path)[0]]

    assert recs(logs["sink_port"]) == recs(logs["sink_jax"])


PAIRS = [
    ("base", "reg", ["--slo"]), ("base", "imp", ["--slo"]), ("base", "base", ["--slo"]),
    ("train", "train_slow", []), ("train", "train", []), ("train_slow", "train", []),
    ("train", "train_slow", ["--threshold", "2.0"]), ("sink_jax", "sink_port", []),
    ("sink_jax", "sink_port", ["--goodput"]), ("train", "train", ["--goodput"]),
    ("train", "base", ["--slo"]), ("tpu_run", "train", []), ("train", "empty", []),
    ("train", "absent", []), ("base", "reg", ["--slo", "--goodput"]),
]


# the exit codes of the pairs whose outcome the gate's purpose fixes: a
# regression, an improvement, no usable input, nothing compared, a bad call
EXIT = {("base", "reg", ("--slo",)): 1, ("base", "imp", ("--slo",)): 0,
        ("train", "train_slow", ()): 1, ("train_slow", "train", ()): 0,
        ("train", "empty", ()): 2, ("train", "absent", ()): 2, ("train", "base", ("--slo",)): 2,
        ("base", "reg", ("--slo", "--goodput")): 2}


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("base,cand,flags", PAIRS)
def test_compare_cli_equals_jax(logs, capsys, base, cand, flags, fmt):
    paths = [logs.get(base, base), logs.get(cand, os.path.join(os.path.dirname(logs["train"]),
                                                              cand))]
    argv = ["compare", *paths, *flags, "--format", fmt]
    rc = obs.main(argv)
    ours = capsys.readouterr()
    assert rc == jax_obs.main(argv)
    theirs = capsys.readouterr()
    assert ours.out == theirs.out
    assert ours.err.replace("tpu_dist_torch.obs", "tpu_dist.obs") == theirs.err
    want = EXIT.get((base, cand, tuple(flags)))
    assert want is None or rc == want


def test_compare_files_equals_jax_and_refuses_bench(logs):
    for kw in ({}, {"slo_only": True}, {"goodput_only": True}, {"threshold": 0.5}):
        got = compare.compare_files(logs["sink_jax"], logs["sink_port"], **kw)
        assert got == jax_compare.compare_files(logs["sink_jax"], logs["sink_port"], **kw)
    from tpu_dist_torch.train.step import NotPortedError

    with pytest.raises(NotPortedError, match="Queue A 2e"):
        compare.compare_files(logs["base"], logs["reg"], bench=True)
    for metric in ("serve_latency_p99_ms", "images_per_sec_mean", "x_per_s", "y_ms"):
        assert compare.direction_of(metric) == jax_compare.direction_of(metric)
    with pytest.raises(KeyError):
        compare.direction_of("no_direction")
    assert compare.SLO_METRICS == jax_compare.SLO_METRICS
    assert compare.REPORT_METRICS == jax_compare.REPORT_METRICS
    assert compare.METRIC_DIRECTIONS == jax_compare.METRIC_DIRECTIONS


@pytest.mark.parametrize("argv", [
    ["summarize", "x.jsonl", "--bench"], ["tail", "x.jsonl"],
    ["archive", "ingest", "x"], ["trend", "a.jsonl"],
    ["hub", "--once", "--run", "a=x.prom", "--archive", "z.jsonl"], ["pod", "a.jsonl"],
    ["compare", "a", "b", "--bench"],
    ["compare", "a", "--against-archive", "z.jsonl"]])
def test_the_subcommands_the_port_lacks_exit_2_naming_their_item(capsys, argv):
    assert obs.main(argv) == 2
    err = capsys.readouterr().err
    assert "not ported to tpu_dist_torch yet" in err and "ROADMAP.md Queue A" in err


def test_the_cli_runs_as_a_module(logs):
    proc = subprocess.run([sys.executable, "-m", "tpu_dist_torch.obs", "compare", logs["base"],
                           logs["reg"], "--slo"], cwd=ROOT, env=child_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "REGRESSED" in proc.stdout
