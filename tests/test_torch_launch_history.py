"""The port's JSONL history (``tpu_dist_torch/metrics/history.py``), its
launcher (``tpu_dist_torch/cli/launch.py``) and the three presets, held to
the JAX package's.

* History: every record of ``Trainer.fit``'s ``log_file`` carries the JAX
  schema's fields (``SCHEMA_VERSION`` 15), and the JAX offline reader
  ``python -m tpu_dist.obs summarize`` reads the file and reports its
  epochs; with ``per_host_log`` rank 1 of 2 writes ``<log_file>.h1``.
* Launcher, on gloo CPU ranks of ``vit_tiny`` (small enough that a rank
  starts and steps in seconds): ``--nproc 2`` exits 0 with one rank-0
  epoch line; a SIGTERM to the launcher makes every rank write its
  snapshot and the launcher exit 75; ``--resume`` then continues to exit 0.
  Each option it does not port raises ``NotPortedError``.
* ``cli/distributed_mp.py`` exits 75 when a spawned rank does.
* The presets ``dataparallel_apex``, ``distributed_apex`` and
  ``distributed_gradient_accumulation`` parse to the JAX presets' configs.
"""

import dataclasses
import importlib
import json
import os
import signal
import subprocess
import sys

import pytest
import torch.multiprocessing as mp
from torch_ranks import child_env, fit_rank, fit_run, free_port, run_ranks

import tpu_dist.config as jax_config
from tpu_dist.metrics import history as jax_history
from tpu_dist.obs import __main__ as jax_obs
from tpu_dist_torch import ckpt
from tpu_dist_torch.cli import distributed_mp, launch
from tpu_dist_torch.cli import train as port_train
from tpu_dist_torch.metrics import history
from tpu_dist_torch.train import step as step_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=64,
           batch_size=16, epochs=2, steps_per_epoch=2, lr=0.02, log_every=1, eval_every=1,
           seed=0, device="cpu")


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_the_history_has_the_jax_schema_and_summarize_reads_it(tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    run = fit_run({**RUN, "port": free_port(), "log_file": path})
    recs = _records(path)
    assert history.SCHEMA_VERSION == jax_history.SCHEMA_VERSION == 15
    # the first dispatch's ledger; an epoch's spans after its record, its goodput
    # window after its eval; then the tail, the totals and the spans' tail
    assert [r["kind"] for r in recs] == ["memory"] + ["train_epoch", "spans", "eval", "goodput"] * 2 + [
        "goodput", "goodput", "spans"]
    for r in recs:
        assert {"ts", "rel_s", "schema_version", "run_id", "kind", "counters"} <= set(r)
        assert r["schema_version"] == 15 and r["run_id"] == recs[0]["run_id"]
    epoch1 = [r for r in recs if r["kind"] == "train_epoch"][1]
    assert epoch1["epoch"] == 1 and epoch1["loss"] == run["epochs"][1]["loss"]
    assert set(run["epochs"][1]) - {"val_top1", "val_top5", "val_loss"} <= set(epoch1)
    assert epoch1["counters"]["train.steps"] == 4
    evals = [r for r in recs if r["kind"] == "eval"]
    assert {"epoch", "top1", "top5", "loss"} <= set(evals[0])
    capsys.readouterr()
    assert jax_obs.main(["summarize", path, "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert [e["epoch"] for e in report["epochs"]] == [0, 1]
    assert report["run_id"] == recs[0]["run_id"] and report["skipped_kinds"] == {}


def test_per_host_log_writes_one_file_a_rank(tmp_path):
    path = str(tmp_path / "run.jsonl")
    cfg = {**RUN, "port": free_port(), "log_file": path, "per_host_log": True, "epochs": 1}
    assert run_ranks(fit_rank, 2, cfg, timeout=120) == [None, None]
    assert sorted(os.listdir(tmp_path)) == ["run.jsonl", "run.jsonl.h1"]
    # host spans are rank 0's alone
    for name, spanned in (("run.jsonl", True), ("run.jsonl.h1", False)):
        assert [r["kind"] for r in _records(str(tmp_path / name))] == [
            "memory", "train_epoch"] + ["spans"] * spanned + [
            "eval", "goodput", "goodput", "goodput"] + ["spans"] * spanned
    assert history.per_rank_path(path, 0) == path


# -- the launcher -----------------------------------------------------------------

TRAIN = [sys.executable, "-m", "tpu_dist_torch.cli.train", "--device", "cpu", "--model",
         "vit_tiny", "--num_classes", "10", "--dataset", "synthetic", "--synthetic_n", "64",
         "--batch_size", "8", "--steps_per_epoch", "2", "--log_every", "1"]


def _launch(nproc: int, *train_args: str):
    env = child_env(PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.cli.launch", "--nproc", str(nproc), "--", *TRAIN,
         *train_args], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def test_launch_two_cpu_ranks():
    proc = _launch(2, "--epochs", "1")
    out, _ = proc.communicate(timeout=180)
    assert proc.returncode == 0, out
    lines = out.splitlines()
    assert sum(line.startswith("Epoch 0 done") for line in lines) == 1, out
    assert sum(line.startswith("tpu_dist_torch: model=vit_tiny ranks=2") for line in lines) == 1


def test_launch_sigterm_exits_75_and_resume_continues(tmp_path):
    d = str(tmp_path)
    log = os.path.join(d, "h.jsonl")
    proc = _launch(2, "--epochs", "1000", "--ckpt_dir", d, "--log_file", log)
    seen = []
    try:
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("Epoch 0 done"):
                proc.send_signal(signal.SIGTERM)
                break
        out, _ = proc.communicate(timeout=180)
    finally:
        proc.kill()
    out = "".join(seen) + out
    assert proc.returncode == 75, out
    assert "=> preempted:" in out and "exiting 75" in out
    newest = ckpt.latest_checkpoint(d)
    assert newest is not None, os.listdir(d)
    path, epoch = newest
    assert ckpt.verify_npz(path)["epoch"] == epoch
    proc = _launch(2, "--epochs", str(epoch + 2), "--ckpt_dir", d, "--log_file", log, "--resume")
    out, _ = proc.communicate(timeout=180)
    assert proc.returncode == 0, out
    assert f"=> resumed from {path}" in out
    kinds = [r["kind"] for r in _records(log)]
    assert "train_epoch" in kinds and "eval" in kinds
    assert ckpt.latest_checkpoint(d)[1] == epoch + 1


@pytest.mark.parametrize("flag", list(launch.UNPORTED))
def test_launch_refuses_each_option_it_does_not_port(flag):
    default = launch.UNPORTED[flag][0]
    value = "somewhere" if default is None else str(default + 1)
    with pytest.raises(step_lib.NotPortedError, match=flag) as info:
        launch.main(["--nproc", "1", f"--{flag}", value, "--", "true"])
    assert info.value.queue.startswith('Queue A "No port owed"')


def test_distributed_mp_exits_75_when_a_rank_is_preempted(monkeypatch):
    def spawn(*a, **k):
        raise mp.ProcessExitedException("process 0 terminated with exit code 75",
                                        error_index=0, error_pid=1, exit_code=75)

    monkeypatch.setattr(mp, "spawn", spawn)
    with pytest.raises(SystemExit) as info:
        distributed_mp.main(["--device", "cpu", "--num_processes", "1"])
    assert info.value.code == 75


# -- the presets ---------------------------------------------------------------------

PRESETS = ["dataparallel_apex", "distributed_apex", "distributed_gradient_accumulation"]
PLACEMENT = {"num_processes", "process_id"}  # the port's DP presets pin a world of one


def _preset_config(package: str, name: str, parse, argv):
    module = importlib.import_module(f"{package}.cli.{name}")
    got = {}

    def capture(argv, **preset):
        got.update(argv=argv, preset=preset)

    mp_ = pytest.MonkeyPatch()
    mp_.setattr(module, "_main", capture)
    try:
        module.main(list(argv))
    finally:
        mp_.undo()
    return dataclasses.asdict(parse(got["argv"], got["preset"]))


def _jax_parse(argv, preset):
    import argparse  # noqa: PLC0415

    parser = argparse.ArgumentParser()
    jax_config.add_reference_flags(parser)
    return jax_config.config_from_args(parser.parse_args(argv), **preset)


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("argv", [[], ["--seed", "7", "--grad_accu_steps", "2", "--lr", "0.05"]],
                         ids=["defaults", "overridden"])
def test_the_presets_parse_to_the_jax_presets_configs(name, argv):
    theirs = _preset_config("tpu_dist", name, _jax_parse, argv)
    ours = _preset_config("tpu_dist_torch", name,
                          lambda a, p: port_train.parse(a, **p), argv)
    common = (set(ours) & set(theirs)) - PLACEMENT
    assert {k: ours[k] for k in common} == {k: theirs[k] for k in common}
    assert ours["memory_check"] == theirs["memory_check"] == "warn"
    assert ours["bf16"] == theirs["bf16"] == (name != "distributed_gradient_accumulation")
    if name == "dataparallel_apex":
        assert (ours["num_processes"], ours["process_id"]) == (1, 0)
    else:
        assert (ours["num_processes"], ours["process_id"]) == (theirs["num_processes"],
                                                                theirs["process_id"])
