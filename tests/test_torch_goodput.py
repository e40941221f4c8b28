"""The live goodput ledger of the port (``tpu_dist_torch/obs/goodput.py``:
``GoodputLedger``, ``fleet_move_phrase``, ``ledger_line``) and the
trainer's attribution (``tpu_dist_torch/train/trainer.py``), held against
the JAX package:

* ``GoodputLedger`` on a manual clock (``t0``, ``now``, and ``timed``
  under a scripted ``time.monotonic``) gives JAX's records and totals,
  record for record and exactly, over seeded scripts of additions, closed
  windows and reads; the phrase and the line render as JAX's do;
* a short port ``fit`` on the CPU (the streaming and the fused path) logs
  a ``goodput`` record an epoch, a ``tail`` and a ``final`` record whose
  buckets sum to their window and to the run's elapsed wall clock (within
  1e-3: ``run_ledger`` and the records round each of the 9 terms to 4
  decimals), whose windows chain to that elapsed time, and which a clock
  around the construction and ``fit`` bounds; its textfile carries the
  ``goodput.*`` gauges of the final totals;
* a SIGTERMed 2-rank run resumed at 1 rank under the fleet decision env
  with cause ``serve_breach`` is charged, by both packages' ``run_ledger``
  alike, to ``preempt_for_serve_s``, its own shutdown tail to ``preempt_s``;
* ``--seed`` makes cuDNN deterministic, and no seed leaves the flags.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch_ranks import elastic_fit_rank, free_port, narrow_resnet, run_ranks

from tpu_dist.obs import goodput as jax_goodput
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.obs import export, goodput, summarize
from tpu_dist_torch.train import trainer

trainer.register_model("narrow_resnet", narrow_resnet)

RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=128,
           batch_size=32, epochs=2, steps_per_epoch=3, lr=0.02, log_every=50, eval_every=1,
           save_every=1, seed=0, device="cpu", num_workers=1)

# the terms run_ledger and the records round to 4 decimals (9 buckets and the
# window): their sum can drift from the rounded total by at most ~5e-4
PARTITION_TOL = 1e-3


# -- the ledger on a manual clock ----------------------------------------------------


def _script(seed: int) -> list:
    """A seeded script of ledger operations on a manual clock."""
    rng = np.random.default_rng(seed)
    now, ops = 100.0, []
    for _ in range(40):
        kind = rng.choice(["add", "add", "add", "timed", "window", "value", "totals"])
        if kind == "add":
            bucket = str(rng.choice(goodput.BUCKETS))
            ops.append(("add", bucket, float(rng.uniform(-0.5, 2.0))))
        elif kind == "timed":
            ops.append(("timed", str(rng.choice(goodput.BUCKETS)), float(rng.uniform(0, 1.5))))
        elif kind == "window":
            now += float(rng.uniform(0.0, 6.0))
            ops.append(("window", now))
        elif kind == "value":
            ops.append(("value", str(rng.choice(goodput.BUCKETS))))
        else:
            ops.append(("totals", now))
    return ops + [("window", now + 1.0), ("totals", now + 1.0)]


def _play(mod, ops, monkeypatch) -> list:
    clock = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    ledger = mod.GoodputLedger(t0=100.0)
    out = []
    for op in ops:
        if op[0] == "add":
            ledger.add(op[1], op[2])
        elif op[0] == "timed":
            clock[0] = 0.0
            with ledger.timed(op[1]):
                clock[0] = op[2]
        elif op[0] == "window":
            out.append(ledger.window_record(now=op[1]))
        elif op[0] == "value":
            out.append(ledger.window_value(op[1]))
        else:
            out.append(ledger.run_totals(now=op[1]))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_the_ledger_on_a_manual_clock_equals_jax(monkeypatch, seed):
    ops = _script(seed)
    assert _play(goodput, ops, monkeypatch) == _play(jax_goodput, ops, monkeypatch)


def test_the_ledger_refuses_what_jax_refuses_and_an_empty_run_is_zero():
    for mod in (goodput, jax_goodput):
        with pytest.raises(ValueError, match="unknown goodput bucket"):
            mod.GoodputLedger(t0=0.0).add("unattributed", 1.0)
    assert goodput.BUCKETS == jax_goodput.BUCKETS
    assert goodput.ALL_BUCKETS == jax_goodput.ALL_BUCKETS
    assert (goodput.GoodputLedger(t0=5.0).run_totals()
            == jax_goodput.GoodputLedger(t0=5.0).run_totals())


@pytest.mark.parametrize("rec", [
    {"donor": "a", "recipient": "b", "chips": 2},
    {"recipient": "svc", "chips": 2, "preempt": True, "decision_id": 4},
    {"donor": "trainer", "chips": 4, "for_run": "svc", "preempt": True, "decision_id": 3},
    {"donor": "trainer", "chips": 1},
    {},
])
def test_fleet_move_phrase_equals_jax(rec):
    assert goodput.fleet_move_phrase(rec) == jax_goodput.fleet_move_phrase(rec)


@pytest.mark.parametrize("totals", [
    {"productive_s": 9.0, "compile_s": 1.25, "elapsed_s": 12.0, "goodput_frac": 0.75},
    {"productive_s": 0.0, "elapsed_s": 0.0, "goodput_frac": 0.0},
    {"productive_s": 3.0, "preempt_for_serve_s": 2.0, "unattributed_s": 0.04,
     "elapsed_s": 5.04, "goodput_frac": 0.5952, "n_segments": 3},
])
def test_ledger_line_equals_jax(totals):
    assert goodput.ledger_line(totals) == jax_goodput.ledger_line(totals)


# -- the trainer's attribution ---------------------------------------------------------


def _records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _bucket_sum(rec: dict) -> float:
    return sum(rec.get(f"{b}_s", 0.0) for b in goodput.ALL_BUCKETS)


@pytest.mark.parametrize("path", ["streaming", "fused"])
def test_a_fit_partitions_its_wall_clock(tmp_path, path):
    kw = dict(RUN, log_file=str(tmp_path / "h.jsonl"), metrics_file=str(tmp_path / "m.prom"),
              ckpt_dir=str(tmp_path / "ck"), port=free_port())
    if path == "fused":
        kw.update(fused_epoch=True, steps_per_epoch=None)
    else:
        kw.update(mid_epoch_save_every=2)
    t_wall = time.monotonic()
    t = trainer.Trainer(TrainConfig(**kw))
    try:
        t.fit()
    finally:
        t.close()
    wall = time.monotonic() - t_wall
    recs = [r for r in _records(kw["log_file"]) if r["kind"] == "goodput"]
    windows = [r for r in recs if not r.get("final")]
    [final] = [r for r in recs if r.get("final")]
    assert [(r["epoch"], bool(r.get("tail"))) for r in windows] == [(0, False), (1, False),
                                                                   (1, True)]
    for r in windows:
        assert abs(_bucket_sum(r) - r["window_s"]) < PARTITION_TOL, r
    assert abs(_bucket_sum(final) - final["elapsed_s"]) < PARTITION_TOL
    assert abs(sum(r["window_s"] for r in windows) - final["elapsed_s"]) < PARTITION_TOL
    assert 0 < final["elapsed_s"] <= wall
    # the regions each path attributes: every epoch trained, evaluated and saved
    assert final["productive_s"] > 0 and final["eval_s"] > 0 and final["ckpt_s"] > 0
    assert final["preempt_s"] == final["recovery_s"] == final["preempt_for_serve_s"] == 0.0
    if path == "streaming":
        # the first step of the process; the fused path's graph is CUDA's only
        assert windows[0]["compile_s"] > 0 and windows[1]["compile_s"] == 0.0
        assert final["data_stall_s"] > 0
    else:
        assert final["compile_s"] == final["data_stall_s"] == 0.0
    ledger = summarize.summarize(_records(kw["log_file"]))["goodput"]
    assert ledger["n_segments"] == 1 and ledger["goodput_frac"] == pytest.approx(
        final["goodput_frac"], abs=2e-4)
    with open(kw["metrics_file"]) as f:
        vals = export.parse(f.read())
    for b in goodput.ALL_BUCKETS:
        assert vals[export.metric_name(f"goodput.{b}_s")] == final[f"{b}_s"]
    assert vals[export.metric_name("goodput.goodput_frac")] == final["goodput_frac"]


def test_a_serve_breach_relaunch_is_charged_to_preempt_for_serve(tmp_path, monkeypatch):
    log, ck = str(tmp_path / "h.jsonl"), str(tmp_path / "ck")
    first = dict(RUN, epochs=2, eval_every=0, log_file=log, ckpt_dir=ck,
                 fault_plan="sigterm@epoch=1:step=0")
    [[r0], [r1]] = run_ranks(elastic_fit_rank, 2, [first], timeout=120)
    assert r0["last"] is None and r1["last"] is None  # preempted
    monkeypatch.setenv("TPU_DIST_FLEET_DECISION_ID", "5")
    monkeypatch.setenv("TPU_DIST_FLEET_DECISION_CAUSE", "serve_breach")
    t = trainer.Trainer(TrainConfig(**dict(RUN, epochs=2, eval_every=0, log_file=log,
                                           ckpt_dir=ck, resume=True, port=free_port())))
    try:
        t.fit()
    finally:
        t.close()
    recs = _records(log)
    [resume] = [r for r in recs if r["kind"] == "resume"]
    assert (resume["prev_dp"], resume["dp"], resume["decision_id"],
            resume["decision_cause"]) == (2, 1, 5, "serve_breach")
    ours, theirs = goodput.run_ledger(recs), jax_goodput.run_ledger(recs)
    assert ours == theirs
    assert ours["n_segments"] == 2 and ours["preempt_for_serve_s"] > 0
    assert ours["preempt_for_serve_s"] == ours["restart_gap_s"]
    assert ours["preempt_s"] > 0  # the first segment's shutdown tail
    assert abs(_bucket_sum(ours) - ours["elapsed_s"]) < PARTITION_TOL


# -- --seed and cuDNN -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, None])
def test_seed_makes_cudnn_deterministic(monkeypatch, seed):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    t = trainer.Trainer(TrainConfig(**dict(RUN, seed=seed, port=free_port())))
    t.close()
    want = (True, False) if seed is not None else (False, True)
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == want
