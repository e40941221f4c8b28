"""Snapshot-then-write sharded checkpoints in the port (``--sharded_ckpt
--async_ckpt``, ``ckpt/checkpoint.py::AsyncShardedCheckpointer``): the
cases of ``tests/test_async_sharded_ckpt.py:76-375`` that have a
counterpart (its traced-step case has none: the port traces nothing). An
async save is the sync one bit for bit; the step loop blocks for the
snapshot only; an injected EIO surfaces at the drain, and the retry ladder
covers the background write; a bounded drain that times out counts what
it abandons; a resave of one stem drains first; a ZeRO-1 vector written
in the background remaps onto another extent; a SIGKILL mid-write leaves a
restorable ladder; SIGTERM through the CLI drains and exits 75; and the
trainer resumes from the async manifests with the goodput partition
whole."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch_ranks import child_env, free_port, layout_state, narrow_resnet

from tpu_dist_torch import bridge, ckpt
from tpu_dist_torch.ckpt import checkpoint as ckpt_lib
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.elastic import remap as remap_lib
from tpu_dist_torch.obs import goodput as goodput_lib
from tpu_dist_torch.resilience import faults, preemption
from tpu_dist_torch.resilience.preemption import PREEMPTION_EXIT_CODE
from tpu_dist_torch.train import step as step_lib
from tpu_dist_torch.train import trainer
from tpu_dist_torch.train.optim import SGD
from tpu_dist_torch.train.state import FlatLayout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_fault_state():
    faults.clear()
    preemption.clear()
    prev = ckpt.set_io_retries(0)
    yield
    ckpt.set_io_retries(prev)
    faults.clear()
    preemption.clear()


def _state(seed=5):
    """A ResNet's state whose momentum is not zero (one SGD step)."""
    st = layout_state("dp", seed=seed)
    rng = np.random.default_rng(seed)
    step = step_lib.make_train_step(SGD())
    st, _ = step(st, rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                 rng.integers(0, 10, 4), 0.1)
    return st


def _shard_crcs(ckpt_dir, stem):
    """{shard file: {entry: crc32}}: the bit-identity key of a save (the
    npz bytes carry zip timestamps)."""
    out = {}
    for name in sorted(os.listdir(ckpt_dir)):
        if name.startswith(f"{stem}.shard") and name.endswith(".npz"):
            with np.load(os.path.join(ckpt_dir, name)) as z:
                out[name] = json.loads(bytes(z["__crc__"].tobytes()).decode())
    return out


def test_async_save_bit_identical_to_sync(tmp_path):
    state = _state()
    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    ckpt.save_sharded(sync_dir, state, 0)
    w = ckpt.AsyncShardedCheckpointer()
    mpath = w.save(async_dir, state, 0)
    assert w.close(timeout=60.0)
    assert _shard_crcs(sync_dir, "ckpt_0") == _shard_crcs(async_dir, "ckpt_0")
    with open(os.path.join(sync_dir, "ckpt_0.manifest.json")) as a, open(mpath) as b:
        assert json.load(a) == json.load(b)
    back = bridge.train_state_to_flat(ckpt.restore_sharded(mpath, layout_state("dp", seed=9)))
    want = bridge.train_state_to_flat(state)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_async_blocks_only_for_snapshot(tmp_path, monkeypatch):
    real_write = ckpt_lib._write_shard_file

    def slow_write(ckpt_dir, snap):
        time.sleep(0.5)
        return real_write(ckpt_dir, snap)

    monkeypatch.setattr(ckpt_lib, "_write_shard_file", slow_write)
    state = _state()
    w = ckpt.AsyncShardedCheckpointer()
    t0 = time.monotonic()
    w.save(str(tmp_path), state, 0)
    blocked = time.monotonic() - t0
    assert blocked < 0.4, f"save() blocked {blocked:.2f}s on the publish"
    assert w.close(timeout=60.0)
    ckpt.verify_sharded(os.path.join(str(tmp_path), "ckpt_0.manifest.json"), deep=True)


def test_eio_mid_background_surfaces_at_drain(tmp_path):
    state = _state()
    w = ckpt.AsyncShardedCheckpointer()
    w.save(str(tmp_path), state, 0)
    assert w.wait(timeout=60.0)  # epoch 0 committed clean
    faults.configure("ckpt_write@call=1")  # the next shard write: EIO
    w.save(str(tmp_path), state, 1)
    with pytest.raises(OSError, match="fault-injected"):
        w.wait(timeout=60.0)
    faults.clear()
    w.close(timeout=60.0)
    found = ckpt.latest_sharded_checkpoint(str(tmp_path))  # epoch 1 never committed
    assert found is not None and found[1] == 0
    ckpt.verify_sharded(found[0], deep=True)


def test_eio_retry_ladder_recovers_in_background(tmp_path):
    ckpt.set_io_retries(2)
    faults.configure("ckpt_write@call=1")
    w = ckpt.AsyncShardedCheckpointer()
    w.save(str(tmp_path), _state(), 0)
    assert w.close(timeout=60.0)
    found = ckpt.latest_sharded_checkpoint(str(tmp_path))
    assert found is not None and found[1] == 0
    ckpt.verify_sharded(found[0], deep=True)


def test_bounded_drain_refuses_loudly(tmp_path, monkeypatch):
    real_write = ckpt_lib._write_shard_file

    def slow_write(ckpt_dir, snap):
        time.sleep(1.5)
        return real_write(ckpt_dir, snap)

    monkeypatch.setattr(ckpt_lib, "_write_shard_file", slow_write)
    w = ckpt.AsyncShardedCheckpointer()
    w.save(str(tmp_path), _state(), 0)
    assert w.close(timeout=0.05) is False
    assert w.in_flight == 1  # the abandoned write is counted, not hidden


def test_same_stem_resave_drains_first(tmp_path):
    state = _state()
    w = ckpt.AsyncShardedCheckpointer()
    w.save_best(str(tmp_path), state, 0, metric=1.0)
    w.save_best(str(tmp_path), state, 1, metric=2.0)
    assert w.close(timeout=60.0)
    mpath = os.path.join(str(tmp_path), "ckpt_best.manifest.json")
    ckpt.verify_sharded(mpath, deep=True)
    assert ckpt.read_sharded_meta(mpath)["metric"] == 2.0


def test_cross_extent_elastic_restore_of_async_written_ckpt(tmp_path):
    """A ZeRO-1 flat vector written by the background path at extent 8
    (its global JAX-order vector: the layout's world is the saving
    world's) remaps onto this run's extent as a sync save's does."""
    st = layout_state("dp", seed=3)
    L = sum(p.numel() for p in st.params.parameters())
    lay8 = FlatLayout(L, 8, 0)
    rng = np.random.default_rng(0)
    vec = np.zeros(lay8.padded, np.float32)
    vec[:L] = rng.standard_normal(L).astype(np.float32)
    # one rank of 8 holding the whole vector: the save writes it whole
    mom = torch.from_numpy(vec.copy())
    st8 = dataclasses.replace(st, opt_state=mom, layout=None, step=5)
    w = ckpt.AsyncShardedCheckpointer()
    mpath = w.save(str(tmp_path), st8, 0,
                   extra_meta={"elastic": ckpt.elastic_stamp(8, 1, L)})
    assert w.close(timeout=60.0)
    one = layout_state("zero1", seed=4)  # extent 1 in this process
    rm = remap_lib.make_remapper(bridge.jax_layout_template(one.params)[0],
                                 ckpt.read_sharded_meta(mpath), 1)
    out = ckpt.restore_sharded(mpath, one, remap=rm)
    assert [k for k, _ in rm.used] == ["['opt_state']"] and out.step == 5
    got = bridge.train_state_to_flat(out)["['opt_state']"]
    assert got.shape == (step_lib.flat_layout(one.params).padded,)
    np.testing.assert_array_equal(got[:L], vec[:L])


_SIGKILL_CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[2])
from torch_ranks import layout_state
from tpu_dist_torch.ckpt import checkpoint as ckpt_lib

ckpt_dir = sys.argv[1]
state = layout_state("dp")
ckpt_lib.save_sharded(ckpt_dir, state, 0)  # the committed floor
real = ckpt_lib._write_shard_file
def slow(d, snap):
    print("WRITE_STARTED", flush=True)  # the parent kills -9 on this line
    time.sleep(30)
    return real(d, snap)
ckpt_lib._write_shard_file = slow
w = ckpt_lib.AsyncShardedCheckpointer()
w.save(ckpt_dir, state, 1)
w.wait()  # never returns: SIGKILL lands mid-write
"""


def test_sigkill_during_background_write_leaves_restorable_ladder(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGKILL_CHILD, str(tmp_path), os.path.join(REPO, "tests")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=child_env(PYTHONPATH=REPO), cwd=REPO)
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:
            if "WRITE_STARTED" in line:
                break
            assert time.monotonic() < deadline, "the child never reached the write"
        proc.kill()  # no cleanup, no drain
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL
    found = ckpt.latest_sharded_checkpoint(str(tmp_path))
    assert found is not None and found[1] == 0, found
    ckpt.verify_sharded(found[0], deep=True)
    back = bridge.train_state_to_flat(ckpt.restore_sharded(found[0], layout_state("dp", 9)))
    want = bridge.train_state_to_flat(layout_state("dp"))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


RUN = ["--dataset", "synthetic", "--model", "narrow_resnet", "--num_classes", "10",
       "--batch_size", "16", "--epochs", "2", "--steps_per_epoch", "3", "--eval_every", "0",
       "--save_every", "1", "--synthetic_n", "64", "--seed", "0", "--log_every", "50",
       "--device", "cpu"]


def test_cli_sigterm_drains_async_sharded_then_exit_75(tmp_path):
    from tpu_dist_torch.cli.train import main  # noqa: PLC0415

    trainer.register_model("narrow_resnet", narrow_resnet)
    with pytest.raises(SystemExit) as ei:
        main([*RUN, "--port", str(free_port()), "--ckpt_dir", str(tmp_path), "--sharded_ckpt",
              "--async_ckpt", "--fault_plan", "sigterm@epoch=0:step=1"])
    assert ei.value.code == PREEMPTION_EXIT_CODE
    found = ckpt.latest_sharded_checkpoint(str(tmp_path))
    assert found is not None, sorted(os.listdir(tmp_path))
    meta = ckpt.verify_sharded(found[0], deep=True)
    assert meta["mid_epoch_step"] == 2


def test_trainer_async_sharded_resume_and_ckpt_accounting(tmp_path):
    trainer.register_model("narrow_resnet", narrow_resnet)
    log = str(tmp_path / "hist.jsonl")
    cfg = TrainConfig(dataset="synthetic", model="narrow_resnet", num_classes=10,
                      batch_size=16, epochs=2, steps_per_epoch=2, eval_every=0, synthetic_n=64,
                      sharded_ckpt=True, async_ckpt=True, ckpt_dir=str(tmp_path / "c"),
                      save_every=1, log_every=10, log_file=log, device="cpu", port=free_port())
    t = trainer.Trainer(cfg)
    try:
        t.fit()
        want = bridge.train_state_to_flat(t.state)
    finally:
        t.close()
    found = ckpt.latest_sharded_checkpoint(cfg.ckpt_dir)
    assert found is not None and found[1] == 1
    ckpt.verify_sharded(found[0], deep=True)
    with open(log) as f:
        records = [json.loads(line) for line in f]
    ledger = goodput_lib.run_ledger(records)
    assert ledger is not None and ledger["ckpt_s"] > 0.0
    parts = sum(ledger[f"{b}_s"] for b in goodput_lib.ALL_BUCKETS)
    assert abs(parts - ledger["elapsed_s"]) < 1e-3, ledger
    t2 = trainer.Trainer(dataclasses.replace(cfg, resume=True, port=free_port()))
    try:
        assert t2.start_epoch == 2  # both epochs committed and visible
        back = bridge.train_state_to_flat(t2.state)
    finally:
        t2.close()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
