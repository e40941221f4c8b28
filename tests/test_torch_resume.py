"""Resume through the port's ``Trainer.fit`` (``tpu_dist_torch/train/
trainer.py``), held to the uninterrupted run.

* f32, one CPU rank: a run stopped by SIGTERM in mid-epoch, after the last
  step of an epoch, at an epoch end, or by a crash after a periodic async
  mid-epoch snapshot, then resumed, gives the uninterrupted run's losses,
  learning rates, eval and final state exactly: the resumed steps are the
  same f32 operations on the same batches in the same order, so nothing
  may differ.
* Two gloo ranks: a SIGTERM that only rank 0 sees stops both ranks at the
  same step (the flag rides the step's metrics all-reduce), and the resume
  gives the uninterrupted run exactly; both ranks restore the same
  checkpoint after rank 0 quarantined the corrupt newest one.
* ``auto_recover`` reloads the newest checkpoint and scales the LR.
* Every checkpoint and history flag works through ``fit``.

The checkpoints that cross between the packages are held in
``tests/test_torch_resume_cross.py``.
"""

import json
import os

import numpy as np
import pytest
from torch_ranks import fit_run, free_port, ladder_rank, resume_rank, run_ranks

from tpu_dist_torch import ckpt

RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=96,
           batch_size=16, epochs=2, steps_per_epoch=3, lr=0.02, lr_milestones=(1,),
           lr_gamma=0.5, log_every=1, eval_every=1, seed=0, device="cpu")


def _port(**kw):
    return {**RUN, "port": free_port(), **kw}


def _lrs(*pairs):
    """The learning rates a run's steps take, as the f32 scalar each is."""
    return [float(np.float32(lr)) for lr, n in pairs for _ in range(n)]


def _assert_same_state(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# case -> (first run's options, its expected stop: steps run, error, the
# mid_epoch_step of the newest checkpoint)
CASES = {
    "sigterm_mid_epoch": (dict(interrupt_at=4), 5, "PreemptedError", 2),
    "sigterm_after_the_last_step": (dict(interrupt_at=2), 3, "PreemptedError", 3),
    "epoch_end": (dict(epochs=1), 3, None, None),
    "crash_after_a_periodic_async_snapshot": (
        dict(kill_at=5, cfg=dict(mid_epoch_save_every=2, async_ckpt=True)), 5,
        "RuntimeError", 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_an_interrupted_f32_run_resumes_exactly(case, tmp_path):
    first, steps, error, mid_step = CASES[case]
    first = dict(first)
    extra = first.pop("cfg", {})
    full = fit_run(_port(ckpt_dir=str(tmp_path / "full"), **extra))
    d = str(tmp_path / "cut")
    cut = fit_run(_port(ckpt_dir=d, **extra), **first)
    assert (len(cut["losses"]), cut["error"]) == (steps, error)
    newest, epoch = ckpt.latest_checkpoint(d)
    assert epoch == (steps - 1) // 3 and ckpt.read_meta(newest).get("mid_epoch_step") == mid_step
    rest = fit_run(_port(ckpt_dir=d, resume=True, **extra))
    assert rest["error"] is None and rest["start_epoch"] == (epoch if mid_step else epoch + 1)
    # exact: the same f32 steps on the same batches (MultiStepLR halves the
    # LR at epoch 1, so a wrong restored epoch would show in the LRs)
    assert cut["losses"] + rest["losses"] == full["losses"]
    assert cut["lrs"] + rest["lrs"] == full["lrs"] == _lrs((0.02, 3), (0.01, 3))
    _assert_same_state(rest["state"], full["state"])
    for key in ("loss", "acc1", "val_loss", "val_top1", "val_top5"):
        assert rest["epochs"][-1][key] == full["epochs"][-1][key], key


def test_two_ranks_stop_at_one_step_and_resume_exactly(tmp_path):
    """SIGTERM reaches rank 0 alone, at its call 4; both ranks must stop
    after that step (5 steps) and resume to the uninterrupted run."""
    ranks = run_ranks(resume_rank, 2, _port(), str(tmp_path), 4, timeout=240)
    for full, cut, rest in ranks:
        assert (len(cut["losses"]), cut["error"]) == (5, "PreemptedError")
        assert cut["losses"] + rest["losses"] == full["losses"]
        _assert_same_state(rest["state"], full["state"])
        meta = cut["meta"]  # the emergency snapshot rank 0 wrote
        assert (meta["epoch"], meta["mid_epoch_step"], meta["mid_epoch_procs"]) == (1, 2, 2)
        assert meta["elastic"]["dp"] == 2 and rest["start_epoch"] == 1
    assert ranks[0][0]["losses"] == ranks[1][0]["losses"]


def _corrupt(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 3)
        f.write(b"\x00" * 4096)


def test_two_ranks_restore_the_checkpoint_rank0_fell_back_to(tmp_path):
    d = str(tmp_path)
    fit_run(_port(ckpt_dir=d, save_every=1))
    _corrupt(os.path.join(d, "ckpt_1.npz"))
    want = ckpt.restore(os.path.join(d, "ckpt_0.npz"), verify=True)
    ranks = run_ranks(ladder_rank, 2, _port(ckpt_dir=d, resume=True), timeout=120)
    for start_epoch, step, state in ranks:
        assert (start_epoch, step) == (1, 3)
        _assert_same_state(state, want)
    assert sorted(os.listdir(d)) == ["ckpt_0.npz", "ckpt_1.npz.corrupt", "ckpt_best.npz"]


def test_auto_recover_reloads_and_scales_the_lr(tmp_path):
    d = str(tmp_path)
    run = fit_run(_port(ckpt_dir=d, save_every=1, auto_recover=1, recover_lr_factor=0.5,
                        log_file=os.path.join(d, "h.jsonl")), nan_at=4)
    assert run["error"] is None and run["lr_scale"] == 0.5
    # epoch 1 diverged at its step 1, reloaded epoch 0 and ran again at half the LR
    assert run["lrs"] == _lrs((0.02, 3), (0.01, 2), (0.005, 3))
    recs = [json.loads(line) for line in open(os.path.join(d, "h.jsonl"))]
    assert [r for r in recs if r["kind"] == "auto_recover"][0]["lr_scale"] == 0.5
    assert ckpt.read_meta(os.path.join(d, "ckpt_1.npz"))["lr_scale"] == 0.5


def test_without_a_checkpoint_auto_recover_raises_the_divergence(tmp_path):
    run = fit_run(_port(auto_recover=1), nan_at=1)
    assert run["error"] == "TrainingDivergedError"


def _flag_ckpt_dir(d, run):
    assert sorted(os.listdir(d)) == ["ckpt_1.npz", "ckpt_best.npz"]
    _assert_same_state(ckpt.restore(os.path.join(d, "ckpt_1.npz"), verify=True), run["state"])


def _flag_resume(d, run):
    again = fit_run(_port(ckpt_dir=d, resume=True, epochs=3))
    assert again["start_epoch"] == 2 and len(again["losses"]) == 3


def _flag_keep_last(d, run):
    assert sorted(os.listdir(d)) == ["ckpt_1.npz", "ckpt_best.npz"]


def _flag_mid_epoch(d, run):
    assert run["error"] == "RuntimeError"
    assert ckpt.read_meta(os.path.join(d, "ckpt_1.npz"))["mid_epoch_step"] == 1


def _flag_async(d, run):
    _flag_ckpt_dir(d, run)


def _flag_auto_recover(d, run):
    assert run["lr_scale"] == 0.5 and run["lrs"][-1] == _lrs((0.005, 1))[0]


def _history(path):
    return [json.loads(line) for line in open(path)]


def _flag_log_file(d, run):
    kinds = [r["kind"] for r in _history(os.path.join(d, "h.jsonl"))]
    assert kinds == ["memory"] + ["train_epoch", "spans", "eval", "goodput"] * 2 + [
        "goodput", "goodput", "spans"]


def _flag_per_host_log(d, run):
    _flag_log_file(d, run)  # a world of one: rank 0 keeps the bare path


# flag -> (options of the run, what fit must leave behind)
FLAGS = {
    "ckpt_dir": (dict(), {}, _flag_ckpt_dir),
    "resume": (dict(), {}, _flag_resume),
    "keep_last_ckpts": (dict(save_every=1, keep_last_ckpts=1), {}, _flag_keep_last),
    "mid_epoch_save_every": (dict(mid_epoch_save_every=1), dict(kill_at=4), _flag_mid_epoch),
    "async_ckpt": (dict(async_ckpt=True), {}, _flag_async),
    "auto_recover": (dict(save_every=1, auto_recover=1), dict(nan_at=3), _flag_auto_recover),
    "log_file": (dict(log_file="h.jsonl"), {}, _flag_log_file),
    "per_host_log": (dict(log_file="h.jsonl", per_host_log=True), {}, _flag_per_host_log),
}


@pytest.mark.parametrize("flag", list(FLAGS))
def test_the_checkpoint_and_history_flags_work_through_fit(flag, tmp_path):
    """The flags ported from ``UNPORTED`` each do their part of a 2-epoch
    ``fit`` on the CPU."""
    cfg, run_kw, check = FLAGS[flag]
    d = str(tmp_path)
    if "log_file" in cfg:
        cfg = {**cfg, "log_file": os.path.join(d, cfg["log_file"])}
    run = fit_run(_port(ckpt_dir=d if flag != "log_file" else None, **cfg), **run_kw)
    check(d, run)
