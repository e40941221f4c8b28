"""The port trainer's health chain (``device_metrics``, ``anomaly_action``,
the NaN guard's order; ``tpu_dist_torch/train/trainer.py``) and the
summary's text (``obs/summarize.py::format_text``) against the JAX
trainer's (``tpu_dist/train/trainer.py:1694-1737``, ``:1992-2103``) and
the JAX package's ``format_text``.

The same runs go through both trainers (the port's narrow ResNet, the JAX
package's ``TinyMLP``: the records' kinds, keys and steps do not depend on
the model) with ``--device_metrics --anomaly_action snapshot``, a 4-point
window and a grad-norm factor of 0.5 (every warm observation out of
cooldown fires, whatever the model's norms):

* ``--fault_plan nan_loss@epoch=0:step=4``: the ``device_stats`` records
  of steps 0-3, the ``grad_norm_explosion`` finding at step 2 and its
  snapshot ``anomaly_0_s3.npz``, off the ``ckpt_`` namespace (no resume
  picks it), then ``TrainingDivergedError`` with the same message: the
  fault reports the NaN after the step, before any fetch of it.
* ``--lr inf``, a really poisoned state (the first update writes inf and
  NaN into the weights): the step-1 observation's ``nonfinite_loss`` and
  ``nonfinite_grads`` findings are logged before the NaN guard raises, in
  the same order and with the same message.

``TrainConfig()``'s health defaults equal JAX's, and ``format_text`` of
the same report (those runs' histories, and one history that holds every
record kind the summary renders) is JAX's, character for character.
"""

import dataclasses
import json
import os

import pytest
import torch_ranks  # noqa: F401  (one torch thread in this process)
from torch_ranks import free_port, narrow_resnet

from tests.helpers import TinyMLP
from tpu_dist import ckpt as jax_ckpt
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.obs import summarize as jax_summ
from tpu_dist.resilience import faults as jax_faults
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch import ckpt
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.obs import summarize
from tpu_dist_torch.resilience import faults
from tpu_dist_torch.train import trainer

jax_trainer.register_model("tiny_mlp_health", lambda num_classes=10: TinyMLP(num_classes,
                                                                            in_dim=3072))
trainer.register_model("narrow_resnet", narrow_resnet)

RUN = dict(dataset="synthetic", num_classes=10, batch_size=16, epochs=1, steps_per_epoch=8,
           synthetic_n=256, log_every=1, eval_every=0, seed=0, device_metrics=True,
           anomaly_action="snapshot", anomaly_window=4, anomaly_grad_spike=0.5)
HEALTH_KINDS = ("device_stats", "anomaly", "straggler", "profile", "profile_analysis",
                "train_epoch")


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _run(root, **kw):
    """The run of ``kw`` through both trainers; returns per package the
    error's message, the history records and the checkpoint directory."""
    out = {}
    for pkg in ("port", "jax"):
        d = os.path.join(root, pkg)
        os.makedirs(d)
        cfg = {**RUN, **kw, "log_file": os.path.join(d, "h.jsonl"),
               "ckpt_dir": os.path.join(d, "ck")}
        err = None
        try:
            if pkg == "port":
                t = trainer.Trainer(TrainConfig(model="narrow_resnet", device="cpu",
                                                port=free_port(), **cfg))
                try:
                    t.fit()
                finally:
                    t.close()
            else:
                jax_trainer.Trainer(JaxConfig(model="tiny_mlp_health", **cfg)).fit()
        except (trainer.TrainingDivergedError, jax_trainer.TrainingDivergedError) as e:
            err = str(e)
        finally:
            faults.clear()
            jax_faults.clear()
        out[pkg] = (err, _records(cfg["log_file"]), cfg["ckpt_dir"])
    return out


def _shape(records):
    """(kind, epoch, step, keys, anomaly) of each health record."""
    skip = {"ts", "rel_s", "run_id", "counters"}
    return [(r["kind"], r.get("epoch"), r.get("step"), sorted(set(r) - skip), r.get("anomaly"))
            for r in records if r["kind"] in HEALTH_KINDS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("health"))
    return {"nan_loss": _run(os.path.join(root, "nan"),
                             fault_plan="nan_loss@epoch=0:step=4"),
            "poisoned": _run(os.path.join(root, "inf"), lr=float("inf"))}


def test_a_nan_loss_fault_writes_jaxs_records_and_snapshot(runs):
    (err, ours, ck), (jerr, theirs, jck) = runs["nan_loss"]["port"], runs["nan_loss"]["jax"]
    assert err == jerr == ("non-finite loss nan at epoch 0 step 4 (lr=0.1) [fault-injected]; "
                           "restore from ckpt_dir to recover")
    assert _shape(ours) == _shape(theirs)
    assert [(r["kind"], r["step"]) for r in ours if r["kind"] in ("device_stats", "anomaly")] == [
        ("device_stats", 0), ("device_stats", 1), ("device_stats", 2),
        ("anomaly", 2), ("device_stats", 3)]
    [finding] = [r for r in ours if r["kind"] == "anomaly"]
    assert finding["anomaly"] == "grad_norm_explosion" and finding["threshold"] == 0.5
    for d, all_ckpts in ((ck, ckpt.all_checkpoints), (jck, jax_ckpt.all_checkpoints)):
        assert sorted(os.listdir(d)) == ["anomaly_0_s3.npz"]
        assert all_ckpts(d) == []  # off the ckpt_ namespace: no resume picks it
    meta = ckpt.read_meta(os.path.join(ck, "anomaly_0_s3.npz"))
    jmeta = ckpt.read_meta(os.path.join(jck, "anomaly_0_s3.npz"))
    assert (meta["anomaly"], meta["mid_epoch_step"]) == (jmeta["anomaly"],
                                                         jmeta["mid_epoch_step"]) == (
        "grad_norm_explosion", 3)


def test_a_poisoned_state_is_found_before_the_guard_raises(runs):
    (err, ours, _), (jerr, theirs, _) = runs["poisoned"]["port"], runs["poisoned"]["jax"]
    assert err == jerr == ("non-finite loss nan at epoch 0 step 1 (lr=inf); "
                           "restore from ckpt_dir to recover")
    assert _shape(ours) == _shape(theirs)
    assert [(r["step"], r["anomaly"]) for r in ours if r["kind"] == "anomaly"] == [
        (1, "nonfinite_loss"), (1, "nonfinite_grads")]
    [nf] = [r for r in ours if r.get("anomaly") == "nonfinite_grads"]
    [stats] = [r for r in ours if r["kind"] == "device_stats" and r["step"] == 1]
    assert nf["value"] == stats["nonfinite_grads"] > 0


def test_the_health_defaults_are_jaxs():
    ours, theirs = dataclasses.asdict(TrainConfig()), dataclasses.asdict(JaxConfig())
    for k in ("device_metrics", "anomaly_action", "anomaly_window", "anomaly_loss_spike",
              "anomaly_grad_spike", "straggler_threshold", "profile_dir", "profile_trigger",
              "profile_steps", "profile_window", "profile_cooldown", "profile_max_captures"):
        assert ours[k] == theirs[k], k


def _every_kind(run_id="r-1"):
    """One history with each record kind the text renders."""
    base = {"ts": 1000.0, "schema_version": 15, "run_id": run_id}
    cats = {"matmul_conv": 0.5, "collective": 0.2, "infeed_outfeed": 0.05,
            "fusion_other": 0.25, "host": 0.0}
    recs = [
        {"kind": "resume", "epoch": 0, "world": 2, "dp": 2, "resharded": True, "prev_dp": 4,
         "restarts": 1, "mid_epoch_step": 3, "decision_id": 7, "decision_cause": "goodput"},
        {"kind": "device_stats", "epoch": 0, "step": 0, "grad_norm": 2.5, "param_norm": 40.0,
         "update_ratio": 0.002, "nonfinite_grads": 0.0},
        {"kind": "anomaly", "anomaly": "loss_spike", "epoch": 0, "step": 5, "value": 9.0,
         "median": 2.0, "ratio": 4.5, "threshold": 3.0},
        {"kind": "anomaly", "anomaly": "nonfinite_loss", "epoch": 0, "step": 6, "value": "nan"},
        {"kind": "alert", "epoch": 0, "step": 2, "rule": "loss_seen", "metric": "loss",
         "value": 2.3, "op": ">", "threshold": -1.0, "sustained": 2},
        {"kind": "profile", "epoch": 0, "event": "start", "reason": "manual", "step": 1,
         "dir": "p/capture_manual_s1_manual", "window_steps": 2},
        {"kind": "profile", "epoch": 0, "event": "stop", "reason": "manual", "start_step": 1,
         "stop_step": 3, "steps": 2, "dir": "p/capture_manual_s1_manual"},
        {"kind": "profile", "epoch": 0, "event": "error", "reason": "anomaly_loss_spike",
         "error": "a profiler capture is already active"},
        {"kind": "profile_analysis", "epoch": 0, "reason": "manual", "dir": "p/c",
         "device_busy_s": 1.0, "categories": cats, "collectives": {"all-reduce": 0.2},
         "collective_frac": 0.2, "overlap_frac": 0.25, "comm_s": 0.2, "infeed_stall_s": 0.05,
         "top_ops": [], "analyzed_traces": 1, "steps": 2, "dropped": {"malformed_trace": 1}},
        {"kind": "profile_analysis", "epoch": 0, "reason": "straggler", "dir": "p/d",
         "error": "p/d: no *.trace.json.gz under it"},
        {"kind": "train_epoch", "epoch": 0, "loss": 2.31, "acc1": 10.0, "acc5": 50.0,
         "epoch_time": 12.5, "images_per_sec": 409.6, "steps": 20, "data_stall_frac": 0.02,
         "step_time_p50": 0.05, "step_time_p95": 0.06, "step_time_p99": 0.07,
         "grad_norm": 2.6, "param_norm": 40.1, "update_ratio": 0.0021,
         "nonfinite_grads": 0.0, "counters": {"train.steps": 20, "comm.all_reduce.grad": 20}},
        {"kind": "straggler", "epoch": 0, "skew": 1.8, "straggler": True, "worst_rank": 1,
         "median_s": 10.2, "max_s": 18.4, "epoch_times": [10.2, 18.4], "stall_fracs": [0, 0.3]},
        {"kind": "eval", "epoch": 0, "top1": 11.0, "top5": 52.0, "loss": 2.29},
        {"kind": "goodput", "epoch": 0, "window_s": 13.0, "productive_s": 11.0,
         "compile_s": 1.0, "data_stall_s": 0.25, "ckpt_s": 0.5, "eval_s": 0.25,
         "unattributed_s": 0.0},
        {"kind": "auto_recover", "epoch": 0, "lr_scale": 0.5},
        {"kind": "device_stats", "epoch": 1, "step": 0, "grad_norm": 3.5, "param_norm": 41.0,
         "update_ratio": 0.003, "nonfinite_grads": 1.0},
        {"kind": "mystery", "epoch": 1},
    ]
    return [{**base, "rel_s": float(i), **r} for i, r in enumerate(recs)]


@pytest.mark.parametrize("which", ["every_kind", "nan_loss", "poisoned"])
def test_format_text_is_jaxs_on_the_same_report(which, runs, tmp_path):
    if which == "every_kind":
        records = _every_kind()
    else:
        records = runs[which]["port"][1]
    ours = summarize.summarize(records, bad_lines=1)
    theirs = jax_summ.summarize(records, bad_lines=1)
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(theirs))
    text = summarize.format_text(ours)
    assert text == jax_summ.format_text(theirs)
    if which == "every_kind":
        for needle in ("capture attribution", "straggler: epoch 0 process 1", "anomaly:",
                       "profile: captured 2 step(s)", "capture FAILED", "analysis FAILED",
                       "device: grad_norm last", "partial epoch 1", "RESHARDED"):
            assert needle in text, needle
    path = tmp_path / "h.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    assert summarize.stamp_capture(dict(ours), str(path)) == jax_summ.stamp_capture(
        dict(theirs), str(path))
