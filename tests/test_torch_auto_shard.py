"""``--auto_shard`` and ``--tune_report`` through the port's trainer
(``Trainer`` and ``cli/train.py``), on CPU gloo ranks with the narrow
ResNet:

* ``--auto_shard apply`` trains bit for bit like the chosen family's flags
  set by hand, on 2 ranks; ``plan`` leaves the config and logs the ``plan``
  record;
* ``--tune_report`` applies the tuner's knob for the run's family, a knob
  the user set wins, and a malformed report raises ``TuneReportError``;
* ``apply`` under ``--tp 2`` is refused with JAX's message;
* a profiled run's drift record holds the plan's prediction
  (``prediction_source: "plan"``), and the CLI prints JAX's
  ``auto_shard=... plan=... (advisory)`` line.
"""

import json
import os

import numpy as np
import pytest
from torch_ranks import auto_shard_rank, free_port, narrow_resnet, run_ranks

from tpu_dist_torch.analysis import overlap, planner
from tpu_dist_torch.cli import train as cli_train
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.train import trainer

RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=64,
           batch_size=16, epochs=1, steps_per_epoch=2, lr=0.02, log_every=1, eval_every=1,
           seed=0, device="cpu")
# a tuner report as JAX writes one: ZeRO-1 chooses two column groups
TUNE = {"schema": "tune_report_v1", "objective": "dispatch_schedule_proxy",
        "families": {"zero1_sgd": {"chosen": {"knobs": {"rs_ag_chunks": 2},
                                              "schedule": {"mean_distance": 1.4}}},
                     "dp_sgd": {"chosen": {"knobs": {}, "schedule": {"mean_distance": 1.0}}}}}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    d = tmp_path_factory.mktemp("auto_shard")
    tune = str(d / "tune.json")
    with open(tune, "w") as f:
        json.dump(TUNE, f)
    cfg = dict(RUN, log_file=str(d / "h.jsonl"), port=free_port())
    return run_ranks(auto_shard_rank, 2, cfg, tune, timeout=240)[0], cfg["log_file"]


def test_apply_trains_like_the_chosen_flags_by_hand(fits):
    runs, _ = fits
    apply, by_hand = runs["apply"], runs["by_hand"]
    family = apply["plan"]["family"]
    assert apply["plan"]["applied"] and apply["plan"]["mode"] == "apply"
    assert family in planner.FAMILY_TRAIN_OVERRIDES
    for k, v in planner.family_train_overrides(family).items():
        assert apply["cfg"][k] == v
    assert apply["cfg"]["auto_shard"] == "apply"
    assert len(apply["losses"]) == 2 and apply["losses"] == by_hand["losses"]
    assert apply["state"].keys() == by_hand["state"].keys()
    assert all(np.array_equal(apply["state"][k], by_hand["state"][k]) for k in apply["state"])


def test_plan_logs_the_record_and_keeps_the_config(fits):
    runs, log = fits
    plan = runs["plan"]
    assert plan["plan"]["mode"] == "plan" and not plan["plan"]["applied"]
    assert plan["plan"]["family"] == runs["apply"]["plan"]["family"]
    assert plan["plan"]["predicted_step_s"] > 0
    assert plan["plan"]["gauge_source"] == "uncalibrated-defaults"
    assert {k: plan["cfg"][k] for k in ("fsdp", "shard_weight_update", "grad_compression")} \
        == {"fsdp": False, "shard_weight_update": False, "grad_compression": "none"}
    # the runs append to one history: apply's record, then plan's (the
    # run with the flags by hand logs none)
    recs = [r for r in _records(log) if r["kind"] == "plan"]
    assert [(r["mode"], r["applied"]) for r in recs] == [("apply", True), ("plan", False)]
    assert recs[-1]["family"] == plan["plan"]["family"]
    assert recs[-1]["predicted_step_s"] == plan["plan"]["predicted_step_s"]


def test_tune_report_applies_and_the_user_knob_wins(fits):
    runs, _ = fits
    tuned, user = runs["tuned"], runs["user_knob"]
    assert tuned["cfg"]["rs_ag_chunks"] == 2
    assert tuned["tune"]["family"] == "zero1_sgd" and tuned["tune"]["applied"] == {
        "rs_ag_chunks": 2}
    assert user["cfg"]["rs_ag_chunks"] == 4
    assert user["tune"]["applied"] == {} and user["tune"]["user_overrides"] == {
        "rs_ag_chunks": 4}
    # schedule knobs move no arithmetic: the chunked ZeRO-1 trains as the
    # unchunked one does, loss for loss
    assert tuned["losses"] == user["losses"]


def _trainer(**kw):
    trainer.register_model("narrow_resnet", narrow_resnet)
    return trainer.Trainer(TrainConfig(**{**RUN, "port": free_port(), **kw}))


def test_malformed_tune_report_raises(tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump({"schema": "tune_report_v1", "families": {"dp_sgd": {"chosen": {}}}}, f)
    with pytest.raises(overlap.TuneReportError, match="chosen entry is missing"):
        _trainer(tune_report=path)


def test_apply_is_refused_under_tp():
    with pytest.raises(ValueError, match="would clobber an explicit sp/tp/ep/pp layout"):
        _trainer(model="vit_tiny", tp=2, auto_shard="apply", sync_bn=False)


def test_auto_shard_must_be_a_known_mode():
    with pytest.raises(ValueError, match="auto_shard must be off|plan|apply"):
        _trainer(auto_shard="always")


def test_a_profiled_run_holds_the_plan_to_its_promise(tmp_path):
    log = str(tmp_path / "h.jsonl")
    t = _trainer(auto_shard="plan", log_file=log, profile_dir=str(tmp_path / "prof"))
    try:
        t.fit()
    finally:
        t.close()
    recs = [r for r in _records(log) if r["kind"] == "plan"]
    assert recs[0]["mode"] == "plan" and "prediction_source" not in recs[0]
    drift = [r for r in recs if "prediction_source" in r]
    assert len(drift) == 1 and drift[0]["prediction_source"] == "plan"
    assert drift[0]["predicted_step_s"] == recs[0]["predicted_step_s"]
    assert drift[0]["family"] == recs[0]["family"] and drift[0]["planner_error_frac"] >= 0


def test_the_cli_prints_the_plan_line(capsys, tmp_path):
    trainer.register_model("narrow_resnet", narrow_resnet)
    argv = ["--model", "narrow_resnet", "--num_classes", "10", "--dataset", "synthetic",
            "--synthetic_n", "32", "--batch_size", "16", "--epochs", "1",
            "--steps_per_epoch", "1", "--device", "cpu", "--port", str(free_port()),
            "--auto_shard", "plan"]
    cli_train.main(argv)
    out = capsys.readouterr().out
    [line] = [ln for ln in out.splitlines() if "auto_shard=plan" in ln]
    assert "(advisory)" in line and "predicted_step=" in line
    assert "[rates: uncalibrated-defaults]" in line
    assert os.environ.get("RANK") is None
