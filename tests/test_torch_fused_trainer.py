"""``Trainer(fused_epoch=True)`` of the port (``tpu_dist_torch/train/
trainer.py`` through ``tpu_dist_torch/train/epoch.py``) on the CPU.

* ``fit`` on 1 and 2 gloo ranks: every epoch runs all its steps (the
  ragged tail dropped), the ranks end equal, the counters read one
  gradient and one metrics all-reduce a step and every test example once
  an eval, and the epoch record has the JAX fused path's keys
  (``tpu_dist/train/trainer.py:1872``: ``data_stall_frac`` 0.0); the JSONL
  history is read by ``python -m tpu_dist.obs summarize``.
* ``python -m tpu_dist_torch.cli.distributed_mp --fused_epoch`` on 2 ranks.
* The refusals: the options JAX's fused runner never receives, a
  mid-epoch snapshot every N steps, and the resume of a mid-epoch snapshot.
* Checkpoints: a fused run stopped after epoch 0 and resumed equals the
  uninterrupted fused run exactly; an end-of-epoch checkpoint of the
  streaming path resumes in the fused path and the other way round; a
  SIGTERM during a fused epoch stops at its end with the epoch saved; a
  Ctrl-C inside a fused epoch writes no snapshot (the state may be half
  trained); a non-finite epoch loss raises.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_ranks import (child_env, fit_run, free_port, fused_fit_rank, narrow_resnet,
                         run_ranks)

from tpu_dist.obs import __main__ as jax_obs
from tpu_dist_torch import ckpt
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.train import trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 100 training images: 6 steps of 16 on one rank (4 dropped), 3 of 8 a
# rank on two (2 dropped); 20 test images
RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=100,
           batch_size=16, epochs=2, lr=0.02, log_every=1, eval_every=1, seed=0,
           device="cpu", fused_epoch=True)
# the keys of the JAX trainer's fused epoch record (mfu needs a known chip)
JAX_FUSED_KEYS = {"loss", "acc1", "acc5", "epoch_time", "images_per_sec", "data_stall_frac"}


def _port(**kw):
    return {**RUN, "port": free_port(), **kw}


def _assert_same_state(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("world", [1, 2])
def test_fit_on_gloo_ranks(world):
    cfg = _port()
    ranks = run_ranks(fused_fit_rank, world, cfg, timeout=240)
    steps = 100 // world // (16 // world)
    for r in ranks:
        assert r["error"] is None and len(r["epochs"]) == 2
        for e in r["epochs"]:
            assert set(e) == JAX_FUSED_KEYS | {"val_top1", "val_top5", "val_loss"}
            assert np.isfinite(e["loss"]) and e["data_stall_frac"] == 0.0
        counts = r["counters"]
        assert counts["train.steps"] == 2 * steps and counts["train.epochs"] == 2
        for kind in ("grad", "metrics"):
            assert counts[f"comm.all_reduce.{kind}"] == 2 * steps
        assert counts["comm.all_reduce.bn"] == counts["comm.all_reduce.bn_grad"] == 2 * steps * 12
        assert counts["eval.examples"] == 2 * 20 and counts["eval.runs"] == 2
        assert r["state"]["['step']"] == 2 * steps
    for r in ranks[1:]:
        assert r["epochs"][-1]["loss"] == ranks[0]["epochs"][-1]["loss"]
        _assert_same_state(r["state"], ranks[0]["state"])


def test_the_history_has_the_fused_record_and_summarize_reads_it(tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    run = fit_run(_port(log_file=path))
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    assert [r["kind"] for r in recs] == ["memory"] + ["train_epoch", "spans", "eval", "goodput"] * 2 + [
        "goodput", "goodput", "spans"]
    epoch1 = recs[5]
    assert epoch1["epoch"] == 1 and epoch1["loss"] == run["epochs"][1]["loss"]
    assert JAX_FUSED_KEYS <= set(epoch1) and epoch1["data_stall_frac"] == 0.0
    capsys.readouterr()
    assert jax_obs.main(["summarize", path, "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert [e["epoch"] for e in report["epochs"]] == [0, 1]


def test_distributed_mp_cli_with_fused_epoch_on_two_cpu_ranks():
    env = child_env(PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.cli.distributed_mp", "--device", "cpu",
         "--num_processes", "2", "--port", str(free_port()), "--dataset", "synthetic",
         "--synthetic_n", "32", "--batch_size", "8", "--epochs", "1", "--fused_epoch"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert sum(line.startswith("Epoch:[0/1] (fused)") for line in lines) == 1, proc.stdout
    assert sum(line.startswith("Epoch 0 done") for line in lines) == 1
    assert sum(line.startswith(" * Acc@1") and "fused" in line for line in lines) == 1


@pytest.mark.parametrize("flag,value", [
    ("grad_accu_steps", 2), ("label_smoothing", 0.1), ("grad_clip_norm", 1.0),
    ("steps_per_epoch", 2), ("mid_epoch_save_every", 2), ("quant_chunk", 64)])
def test_fused_epoch_refuses_the_options_its_runner_never_receives(flag, value):
    assert trainer.FUSED_REFUSED[flag][0] != value
    with pytest.raises(ValueError, match=f"{flag}=.*--fused_epoch"):
        trainer.Trainer(TrainConfig(**_port(**{flag: value})))


def test_the_refusal_cases_cover_every_refused_option():
    # remat's refusal case is in tests/test_torch_trainer_optim.py
    assert sorted(trainer.FUSED_REFUSED) == sorted(
        ["grad_accu_steps", "label_smoothing", "grad_clip_norm", "steps_per_epoch",
         "mid_epoch_save_every", "remat", "quant_chunk"])
    # without fused_epoch, each is an ordinary option
    trainer.refuse_fused_options(TrainConfig(**{**RUN, "fused_epoch": False,
                                                "grad_accu_steps": 2}))


def test_a_mid_epoch_snapshot_does_not_resume_in_the_fused_path(tmp_path):
    d = str(tmp_path)
    cut = fit_run(_port(fused_epoch=False, steps_per_epoch=3, ckpt_dir=d), interrupt_at=1)
    assert cut["error"] == "PreemptedError"
    assert ckpt.read_meta(os.path.join(d, "ckpt_0.npz"))["mid_epoch_step"] == 2
    with pytest.raises(ValueError, match="mid-epoch resume"):
        fit_run(_port(ckpt_dir=d, resume=True))


def test_a_fused_resume_equals_the_uninterrupted_fused_run(tmp_path):
    full = fit_run(_port(ckpt_dir=str(tmp_path / "full")))
    first = fit_run(_port(ckpt_dir=str(tmp_path / "cut"), epochs=1))
    rest = fit_run(_port(ckpt_dir=str(tmp_path / "cut"), resume=True))
    assert rest["start_epoch"] == 1 and len(rest["epochs"]) == 1
    assert first["epochs"][0]["loss"] == full["epochs"][0]["loss"]
    assert rest["epochs"][0]["loss"] == full["epochs"][1]["loss"]
    _assert_same_state(rest["state"], full["state"])


@pytest.mark.parametrize("first_fused", [False, True], ids=["streaming_then_fused",
                                                            "fused_then_streaming"])
def test_an_epoch_checkpoint_crosses_between_the_paths(first_fused, tmp_path):
    d = str(tmp_path)
    streaming = dict(fused_epoch=False, steps_per_epoch=3)
    first = fit_run(_port(ckpt_dir=d, epochs=1, **({} if first_fused else streaming)))
    saved = ckpt.restore(os.path.join(d, "ckpt_0.npz"))
    _assert_same_state(saved, first["state"])
    rest = fit_run(_port(ckpt_dir=d, resume=True, **(streaming if first_fused else {})))
    assert rest["error"] is None and rest["start_epoch"] == 1 and len(rest["epochs"]) == 1
    assert np.isfinite(rest["epochs"][0]["loss"])
    steps = 3 if first_fused else 100 // 16
    assert rest["state"]["['step']"] == first["state"]["['step']"] + steps


def test_sigterm_during_a_fused_epoch_stops_at_its_end(tmp_path):
    d = str(tmp_path)
    trainer.register_model("narrow_resnet", narrow_resnet)
    t = trainer.Trainer(TrainConfig(**_port(ckpt_dir=d, epochs=3)))
    inner = t.train_epoch

    def train_epoch(epoch, *a, **k):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)  # the flag only: the epoch runs
        return inner(epoch, *a, **k)

    t.train_epoch = train_epoch
    try:
        with pytest.raises(trainer.PreemptedError, match="fused epoch 1"):
            t.fit()
    finally:
        t.close()
    meta = ckpt.read_meta(os.path.join(d, "ckpt_1.npz"))
    assert meta["epoch"] == 1 and "mid_epoch_step" not in meta
    assert meta["step"] == 2 * (100 // 16)
    full = fit_run(_port(ckpt_dir=str(tmp_path / "full"), epochs=3))
    rest = fit_run(_port(ckpt_dir=d, epochs=3, resume=True))
    assert rest["start_epoch"] == 2
    _assert_same_state(rest["state"], full["state"])


def test_an_interrupt_inside_a_fused_epoch_writes_no_snapshot(tmp_path, capsys):
    d = str(tmp_path)
    trainer.register_model("narrow_resnet", narrow_resnet)
    t = trainer.Trainer(TrainConfig(**_port(ckpt_dir=d)))

    def interrupted(*a, **k):
        raise KeyboardInterrupt

    t._fused_runner.run = interrupted
    try:
        with pytest.raises(KeyboardInterrupt):
            t.fit()
    finally:
        t.close()
    assert os.listdir(d) == []
    assert "inside a step (or a fused epoch)" in capsys.readouterr().out


def test_a_non_finite_fused_epoch_loss_raises():
    trainer.register_model("narrow_resnet", narrow_resnet)
    t = trainer.Trainer(TrainConfig(**_port()))
    inner = t._fused_runner.run

    def nan_run(*a, **k):
        state, metrics = inner(*a, **k)
        metrics["loss"] = torch.full((), float("nan"))
        return state, metrics

    t._fused_runner.run = nan_run
    try:
        with pytest.raises(trainer.TrainingDivergedError, match="fused epoch 0"):
            t.fit()
    finally:
        t.close()
