"""The port trainer's ``crash_dir`` (``tpu_dist_torch/train/trainer.py``) held
against the JAX trainer's (``tpu_dist/train/trainer.py:2652-2690``,
``:1672-1676``, ``:1854-1856``, ``:2958-3036``).

* A narrow ResNet ``Trainer(crash_dir=..., ckpt_dir=...)`` on 1 and 2 gloo
  ranks, on the streaming and the fused paths: every rank's flight ring
  holds the JAX trainer's records in the JAX order, kind and ``(epoch,
  step)`` for kind: ``open``, a ``step`` record at each step boundary (one
  an epoch, step None, when fused), the checkpoint spans, ``exit`` with
  ``clean``. The JAX trainer runs on a 1-device mesh: its ring does not
  depend on the world size. The loader's ``loader/produce`` spans come from
  the producer thread, whose interleaving with the main thread's records
  is a race in both packages, and are compared as a count.
* A resumed run stamps ``resume`` after ``open``; a SIGTERM'd run ends in
  ``preempt`` (``python -m tpu_dist_torch.obs postmortem``: ``preempted``);
  a raised ``torch.OutOfMemoryError`` writes ``oom.json``, a ``memory``
  OOM history record and an ``oom`` ring record, and reads as ``oom``; a
  training process SIGKILLed mid-epoch leaves a ring that ends at its last
  completed step (``no-clean-exit``), and its ``stacks.txt`` holds a
  SIGUSR1 dump.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import pytest
import torch
from torch_ranks import child_env, fit_run, free_port, run_ranks

import tpu_dist.data.native as jax_native
from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.obs import flight as jax_flight
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch.obs import flight, postmortem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(block="basic", stage_blocks=(1, 1, 1, 1), widths=(8, 16, 32, 64))
STREAM = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=64,
              batch_size=16, epochs=2, steps_per_epoch=3, lr=0.02, log_every=1,
              eval_every=1, seed=0, save_every=1)
FUSED = dict(STREAM, steps_per_epoch=None, fused_epoch=True)
PATHS = {"stream": STREAM, "fused": FUSED}


def _shape(path):
    """The ring's records as (kind, epoch, step) or (span, name), the
    producer thread's loader spans apart, as a count."""
    recs = flight.decode(path)["records"]
    assert recs == jax_flight.decode(path)["records"]
    seq = [(r["kind"], r["name"]) if r["kind"] == "span" else
           (r["kind"], r.get("epoch"), r.get("step")) for r in recs
           if r.get("name") != "loader/produce"]
    loader = sum(r.get("name") == "loader/produce" for r in recs)
    return seq, loader, recs[-1]


@pytest.fixture(scope="module")
def jax_rings(tmp_path_factory):
    jax_trainer.register_model("narrow_resnet", lambda num_classes: ResNetDef(
        NARROW["block"], NARROW["stage_blocks"], num_classes, widths=NARROW["widths"]))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_load", lambda: None)
    out = {}
    try:
        for name, cfg in PATHS.items():
            d = str(tmp_path_factory.mktemp(f"jax_{name}"))
            t = jax_trainer.Trainer(
                JaxConfig(**cfg, crash_dir=os.path.join(d, "crash"),
                          ckpt_dir=os.path.join(d, "ck")),
                mesh=mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS], jax.devices()[:1]))
            t.fit()
            out[name] = _shape(os.path.join(d, "crash", flight.RING_NAME))
    finally:
        mp.undo()
    return out


def _port_cfg(name, d, **kw):
    return {**PATHS[name], "device": "cpu", "port": free_port(),
            "crash_dir": os.path.join(d, "crash"), "ckpt_dir": os.path.join(d, "ck"), **kw}


def _both_paths_rank(rank, world, root):
    from torch_ranks import fit_run as run  # noqa: PLC0415

    for name in PATHS:
        d = os.path.join(root, name)
        cfg = {**_port_cfg(name, d), "port": None}
        cfg.pop("port")
        assert run(cfg)["error"] is None
    return rank


@pytest.mark.parametrize("world", [1, 2])
def test_the_ring_has_the_jax_trainers_records(tmp_path, jax_rings, world):
    if world == 1:
        for name in PATHS:
            assert fit_run(_port_cfg(name, str(tmp_path / name)))["error"] is None
    else:
        assert run_ranks(_both_paths_rank, 2, str(tmp_path), timeout=120) == [0, 1]
    for name in PATHS:
        want, want_loader, _ = jax_rings[name]
        for rank in range(world):
            ring = os.path.join(tmp_path, name, "crash",
                                flight.RING_NAME + (f".h{rank}" if rank else ""))
            got, loader, last = _shape(ring)
            # only rank 0 writes checkpoints, so only its ring has their spans
            assert got == (want if rank == 0 else [w for w in want if w[0] != "span"]), (
                name, rank)
            assert last["kind"] == "exit" and last["clean"] is True
            assert (loader == want_loader) if name == "stream" else loader == 0
            assert os.path.exists(os.path.join(tmp_path, name, "crash", flight.STACKS_NAME
                                               + (f".h{rank}" if rank else "")))
    steps = [s for s in jax_rings["stream"][0] if s[0] == "step"]
    assert steps == [("step", e, s) for e in range(2) for s in range(3)]
    assert [s for s in jax_rings["fused"][0] if s[0] == "step"] == [("step", 0, None),
                                                                   ("step", 1, None)]


def test_a_resume_stamps_resume_and_a_sigterm_ends_in_preempt(tmp_path):
    d = str(tmp_path)
    assert fit_run(_port_cfg("stream", d, epochs=1))["error"] is None
    run = fit_run(_port_cfg("stream", d, resume=True), interrupt_at=1)
    assert run["error"] == "PreemptedError"
    got, _, last = _shape(os.path.join(d, "crash", flight.RING_NAME))
    assert got[:2] == [("open", 1, None), ("resume", 0, None)]  # the restored epoch, as JAX
    assert [s for s in got if s[0] == "step"] == [("step", 1, 0), ("step", 1, 1)]
    assert last == {**last, "kind": "preempt", "epoch": 1}
    rank0 = postmortem.assemble([os.path.join(d, "crash")])["ranks"][0]
    assert rank0["verdict"] == "preempted" and rank0["flight"]["last_step"]["step"] == 1


def test_an_out_of_memory_error_writes_oom_json_and_reads_as_oom(tmp_path, monkeypatch):
    from tpu_dist_torch.train import trainer

    d = str(tmp_path)
    inner = trainer.make_train_step

    def make(*a, **k):
        step = inner(*a, **k)
        calls = [0]

        def oom_on_the_second(st, images, labels, lr):
            calls[0] += 1
            if calls[0] == 2:
                raise torch.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 20.00 MiB. GPU 0 has a total "
                    "capacity of 79.10 GiB of which 3.06 MiB is free. Of the allocated memory "
                    "78.90 GiB is allocated by PyTorch, and 10.00 MiB is reserved by PyTorch "
                    "but unallocated.")
            return step(st, images, labels, lr)
        return oom_on_the_second

    monkeypatch.setattr(trainer, "make_train_step", make)
    log = os.path.join(d, "run.jsonl")
    with pytest.raises(torch.OutOfMemoryError):
        t = trainer.Trainer(trainer.TrainConfig(**_port_cfg("stream", d, log_file=log)))
        try:
            t.fit()
        finally:
            t.close()
    crash = os.path.join(d, "crash")
    with open(os.path.join(crash, "oom.json")) as f:
        rep = json.load(f)
    # beside the report, the first dispatch's ledger snapshot (the history's
    # memory record before the OOM one)
    assert rep["oom"]["requested_bytes"] == 20 * 1024 ** 2
    with open(log) as f:
        mem = [json.loads(line) for line in f if '"memory"' in line]
    assert [m.get("event") for m in mem] == [None, "oom"]
    snap = {k: mem[0][k] for k in ("census", "reconciliation", "static")}
    assert rep["ledger"] == mem[1]["ledger"] == snap and mem[1]["epoch"] == 0
    got, _, last = _shape(os.path.join(crash, flight.RING_NAME))
    assert [g[0] for g in got[-4:]] == ["step", "oom", "fatal", "exit"]
    assert last["clean"] is False
    rank0 = postmortem.assemble([crash])["ranks"][0]
    assert rank0["verdict"] == "oom"
    assert "OOM: requested 20.0MiB" in postmortem.format_text(postmortem.assemble([crash]))


def test_a_sigkilled_training_process_leaves_its_last_step(tmp_path):
    d = str(tmp_path)
    crash = os.path.join(d, "crash")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.cli.train", "--device", "cpu", "--model",
         "vit_tiny", "--num_classes", "10", "--dataset", "synthetic", "--synthetic_n", "2048",
         "--batch_size", "8", "--epochs", "5", "--log_every", "1000", "--crash_dir", crash,
         "--port", str(free_port())],
        cwd=ROOT, env=child_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    ring = os.path.join(crash, flight.RING_NAME)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if os.path.exists(ring) and (flight.last_step(flight.decode(ring)) or {}).get(
                    "step", -1) >= 3:
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGUSR1)  # the all-threads dump, then the kill
        time.sleep(0.5)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    dec = flight.decode(ring)
    last = flight.last_step(dec)
    # no terminal record: the ring just stops (the loader thread's span
    # slots may follow the last step's)
    assert last["step"] >= 3 and dec["torn_slots"] <= 1
    after = dec["records"][dec["records"].index(last) + 1:]
    assert all(r["kind"] == "span" for r in after)
    steps = [r["step"] for r in dec["records"] if r["kind"] == "step"]
    assert steps == list(range(steps[0], last["step"] + 1))
    rank0 = postmortem.assemble([crash])["ranks"][0]
    assert rank0["verdict"] == "no-clean-exit"
    assert rank0["stack"]["n_dumps"] == 1 and rank0["stack"]["stuck_frame"]
