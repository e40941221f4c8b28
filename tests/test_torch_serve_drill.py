"""The port's serving drill (``tpu_dist_torch/serve/drill.py``, ``python -m
tpu_dist_torch.serve drill``) held against the JAX package's
(``tpu_dist/serve/drill.py``).

* ``run_drill`` passes on the CPU: the dp = 4 ZeRO-1 checkpoint restores
  through the remapper bit for bit, the baseline replay completes every
  request with zero post-warmup retraces and intact histograms, and
  ``obs compare --slo`` exits 1 on the regression and 0 on the
  improvement; the CLI runs it as a module.
* The baseline replay's ``serve`` and ``alert`` records equal a JAX
  ``replay`` of the same trace on the same ``ManualClock`` step, but for
  the wall-clock fields (``ts``, ``rel_s``, ``counters``). One JAX replay
  serves the module, so its bucket ladder compiles once. The replay's
  records hold only clock readings and counts, so the comparison is
  exact; the logits (which differ by f32 summation order) are not in them.
* The geometry and the trace are the JAX drill's.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_dist.obs import counters as jax_counters
from tpu_dist.serve import drill as jax_drill
from tpu_dist.serve import engine as jax_engine
from tpu_dist_torch.obs import counters
from tpu_dist_torch.serve import drill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL = ("ts", "rel_s", "counters")


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in WALL} for r in recs
            if r["kind"] in ("serve", "alert")]


@pytest.fixture(scope="module")
def jax_baseline(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_drill"))
    model = jax_drill._drill_model()
    jax_drill.write_training_ckpt(os.path.join(d, "ckpt"), model)
    loaded = jax_engine.load_serving_state(os.path.join(d, "ckpt"), model)
    out = jax_drill.replay(d, "baseline", model, loaded, auto_step_s=jax_drill.BASE_STEP_S)
    jax_counters.reset()
    return {"records": _records(out["log"]), "completed": out["completed"],
            "stats": out["stats"], "loaded": jax.tree_util.tree_map(np.asarray, loaded)}


def test_the_drill_passes_on_the_cpu(tmp_path, capsys):
    summary = drill.run_drill(str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "serve-drill OK: 48 requests" in out
    assert summary["compare_slo"] == {"regression_rc": 1, "improvement_rc": 0}
    assert summary["remapped"] == [("['opt_state']", "zero1_flat")]
    assert summary["retraces_post_warmup"] == 0 and summary["windows"] == 5
    counters.reset()


def test_the_baseline_replay_records_equal_a_jax_replay(tmp_path, jax_baseline):
    model = drill._drill_model("cpu")
    # the same restored weights as the JAX replay's (only shapes matter here)
    ours = drill.replay(str(tmp_path), "baseline", model, jax_baseline["loaded"],
                        auto_step_s=drill.BASE_STEP_S, device="cpu")
    counters.reset()
    got = _records(ours["log"])
    assert got == jax_baseline["records"]
    assert ours["completed"] == jax_baseline["completed"] == drill.N_REQUESTS
    kinds = [r["kind"] for r in got]
    assert kinds.count("serve") == 5  # 4 windows of 3 ticks and the final one
    theirs = jax_baseline["stats"]
    assert ours["stats"].total.to_dict() == theirs.total.to_dict()
    assert ours["stats"].check_invariants() == theirs.check_invariants() == []


def test_the_geometry_and_trace_are_the_jax_drills():
    for name in ("TRACE_SPACING_S", "TRACE_BURST_EXTRA_S", "TICK_S", "WINDOW_TICKS",
                 "N_REQUESTS", "IMAGE_SHAPE", "MAX_BATCH", "BASE_STEP_S", "REGRESSED_STEP_S",
                 "IMPROVED_STEP_S"):
        assert getattr(drill, name) == getattr(jax_drill, name), name
    assert drill.default_trace() == jax_drill.default_trace()
    ours, theirs = drill.ManualClock(0.25), jax_drill.ManualClock(0.25)
    for t in (0.0, 1.0, 0.5):
        ours.advance_to(t)
        theirs.advance_to(t)
        assert (ours(), ours()) == (theirs(), theirs())
    assert ours.readings == theirs.readings


def test_the_drill_model_has_the_jax_drills_parameters():
    from tpu_dist_torch import bridge

    ours = bridge.keystr_flatten(bridge.jax_layout_template(drill._drill_model("cpu"))[0])
    params, _ = jax_drill._drill_model().init(jax.random.PRNGKey(0))
    theirs = {jax.tree_util.keystr(p): np.shape(v)
              for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {k: v.shape for k, v in ours.items()} == theirs


def test_the_drill_runs_from_the_cli(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "tpu_dist_torch.serve", "drill", "--workdir",
                           str(tmp_path), "--device", "cpu", "--format", "json"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert summary["requests"] == 48 and summary["compare_slo"]["regression_rc"] == 1


def test_the_drill_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    """``_drill_model``, ``replay`` and ``run_drill`` default to CUDA, as
    every entry point of the port does: without a GPU they raise."""
    if torch.cuda.is_available():
        assert next(drill._drill_model().parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drill._drill_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drill.run_drill(str(tmp_path))
