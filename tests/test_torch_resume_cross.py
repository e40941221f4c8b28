"""Checkpoints across the two packages' trainers: a JAX ``Trainer``
checkpoint taken after epoch 0 resumes in the port's ``Trainer``, and a
port checkpoint in the JAX ``Trainer``; each resumed epoch matches the
other package's uninterrupted epoch 1 to the 2e-3 relative of
``tests/test_torch_trainer.py`` (ROADMAP Queue C: XLA's f32 gradients on
cropped inputs on the CPU).

* SGD, with both packages' augmentation held to the numpy path.
* AdamW (``['opt_state']['mu']``, ``['nu']``, ``['count']``), with nothing
  pinned: both trainers take the C++ input pipeline, which gives both the
  same batches. The port's run starts from the JAX run's initial weights,
  so their epochs also agree one by one (``Trainer.fit`` parity). A
  resume under another ``adamw_decay_mask`` than the checkpoint's stamp
  raises ``ConfigMismatchError`` in both packages, and either package's
  AdamW checkpoint serves through the port's ``load_serving_state`` with
  f32 logits bit for bit.
* ZeRO-1 with ``int8_ef``, mid-epoch, at another world: a JAX snapshot at
  dp 4 (one process) resumes in the port at 2 gloo ranks, and a port
  snapshot at 2 ranks in the JAX trainer at dp 4. The flat momentum and
  the residual rows are re-laid (their prefix, and the residuals' total,
  bit for bit), the process count changes, so both re-enter at the
  consumed-example offset, and the resumed runs train on. The two
  packages draw their int8 rounding from other streams, so no loss is
  compared here.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
from torch_ranks import elastic_fit_rank, fit_run, free_port, narrow_resnet, run_ranks

import tpu_dist.data.native as jax_native
import tpu_dist_torch.data.native as port_native
from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.elastic.errors import ConfigMismatchError as JaxConfigMismatchError
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.obs import counters as jax_counters
from tpu_dist.resilience import faults as jax_faults
from tpu_dist.resilience import preemption as jax_preemption
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch import bridge, ckpt
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.serve.engine import ServingEngine, load_serving_state
from tpu_dist_torch.train import trainer

RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=96,
           batch_size=16, epochs=2, steps_per_epoch=3, lr=0.02, lr_milestones=(1,),
           lr_gamma=0.5, log_every=1, eval_every=1, seed=0, device="cpu")


def _port(**kw):
    return {**RUN, "port": free_port(), **kw}


def _lrs(*pairs):
    """The learning rates a run's steps take, as the f32 scalar each is."""
    return [float(np.float32(lr)) for lr, n in pairs for _ in range(n)]


JAX_RUN = {k: v for k, v in RUN.items() if k != "device"}
# 6 f32 steps at lr 0.02 then 0.01 from the same checkpoint on the same
# batches; XLA's f32 gradients on the loader's zero-padded crops are up to
# ~1% off f64 on the CPU, the port's ~1e-6 (ROADMAP Queue C), which moves
# the loss by up to ~8e-4 relative over such steps: 2e-3 relative, as in
# tests/test_torch_trainer.py. Hit counts of logits that close agree but
# for near-ties: at most one example of the 16 in a step, of the 19 in
# the eval.
LOSS_TOL = dict(rtol=2e-3)


def _register():
    jax_trainer.register_model("narrow_resnet", lambda num_classes: ResNetDef(
        "basic", (1, 1, 1, 1), num_classes, widths=(8, 16, 32, 64)))
    trainer.register_model("narrow_resnet", narrow_resnet)


def _jax_trainer(cfg_kw):
    """A JAX ``Trainer`` on a one-device mesh whose epoch dicts are kept."""
    epochs, t = [], jax_trainer.Trainer(
        JaxConfig(**cfg_kw), mesh=mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS],
                                                       jax.devices()[:1]))
    inner = t.train_epoch

    def train_epoch(epoch, *a, **k):
        epochs.append(inner(epoch, *a, **k))
        return epochs[-1]

    t.train_epoch = train_epoch
    return t, epochs


def _jax_fit(cfg_kw):
    t, epochs = _jax_trainer(cfg_kw)
    t.fit()
    return t, epochs


def _copy_epoch0(root, src, dst):
    os.makedirs(root / dst)
    shutil.copy(root / src / "ckpt_0.npz", root / dst / "ckpt_0.npz")


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """Each package's uninterrupted 2-epoch run with a checkpoint after every
    epoch, and each one's epoch 1 resumed by the other from epoch 0."""
    root = tmp_path_factory.mktemp("crossed")
    _register()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_load", lambda: None)  # the numpy augmentation path
    mp.setattr(port_native, "_load", lambda: None)
    try:
        jax_full = _jax_fit({**JAX_RUN, "ckpt_dir": str(root / "jax"), "save_every": 1})[1]
        port_full = fit_run(_port(ckpt_dir=str(root / "port"), save_every=1))
        for src, dst in (("jax", "jax0"), ("port", "port0")):
            _copy_epoch0(root, src, dst)
        port_from_jax = fit_run(_port(ckpt_dir=str(root / "jax0"), resume=True))
        jt, jax_from_port = _jax_fit({**JAX_RUN, "ckpt_dir": str(root / "port0"),
                                      "resume": True})
    finally:
        mp.undo()
    return jax_full, port_full, port_from_jax, (jt, jax_from_port)


def _assert_epoch_close(ours, theirs):
    assert ours["steps"] == theirs["steps"] == 3
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(ours[key], theirs[key], **LOSS_TOL, err_msg=key)
    for key, n in (("acc1", 16), ("acc5", 16), ("val_top1", 19), ("val_top5", 19)):
        assert abs(ours[key] - theirs[key]) <= 100.0 / n + 1e-9, key


def test_a_jax_trainer_checkpoint_resumes_in_the_port(crossed):
    jax_full, _, port_from_jax, _ = crossed
    assert port_from_jax["start_epoch"] == 1 and len(port_from_jax["epochs"]) == 1
    assert port_from_jax["lrs"] == _lrs((0.01, 3))
    _assert_epoch_close(port_from_jax["epochs"][0], jax_full[1])


def test_a_port_checkpoint_resumes_in_the_jax_trainer(crossed):
    _, port_full, _, (jt, jax_from_port) = crossed
    assert jt.start_epoch == 1 and len(jax_from_port) == 1 and int(jt.state.step) == 6
    _assert_epoch_close(port_full["epochs"][1], jax_from_port[0])


# -- AdamW -----------------------------------------------------------------------

ADAMW = dict(optimizer="adamw", lr=1e-3, weight_decay=0.05, adamw_decay_mask="auto")


def _port_fit_from(init, cfg_kw):
    """The port's ``Trainer.fit`` from the JAX run's initial weights;
    returns its epoch dicts."""
    t = trainer.Trainer(TrainConfig(**cfg_kw))
    epochs, inner = [], t.train_epoch

    def train_epoch(epoch, *a, **k):
        epochs.append(inner(epoch, *a, **k))
        return epochs[-1]

    t.train_epoch = train_epoch
    try:
        assert t.input_pipeline.startswith("native")
        bridge.load_jax_resnet(t.model, *init)
        t.fit()
    finally:
        t.close()
    return epochs


@pytest.fixture(scope="module")
def adamw_crossed(tmp_path_factory):
    """The AdamW runs, nothing pinned: JAX's 2 epochs, the port's 2 epochs
    from the same initial weights, and each one's epoch 1 resumed by the
    other from epoch 0."""
    root = tmp_path_factory.mktemp("adamw")
    _register()
    jt, jax_full = _jax_trainer({**JAX_RUN, **ADAMW, "ckpt_dir": str(root / "jax"),
                                 "save_every": 1})
    init = tuple(jax.tree_util.tree_map(np.asarray, t)
                 for t in jax.device_get((jt.state.params, jt.state.bn_state)))
    jt.fit()
    port_full = _port_fit_from(init, _port(**ADAMW, ckpt_dir=str(root / "port"), save_every=1))
    for src, dst in (("jax", "jax0"), ("port", "port0")):
        _copy_epoch0(root, src, dst)
    port_from_jax = fit_run(_port(**ADAMW, ckpt_dir=str(root / "jax0"), resume=True))
    jt2, jax_from_port = _jax_fit({**JAX_RUN, **ADAMW, "ckpt_dir": str(root / "port0"),
                                   "resume": True})
    return dict(root=root, jax_full=jax_full, port_full=port_full, port_from_jax=port_from_jax,
                jax_from_port=(jt2, jax_from_port))


def test_adamw_fit_matches_the_jax_trainer_epoch_by_epoch(adamw_crossed):
    jax_full, port_full = adamw_crossed["jax_full"], adamw_crossed["port_full"]
    assert len(jax_full) == len(port_full) == 2
    for ours, theirs in zip(port_full, jax_full):
        _assert_epoch_close(ours, theirs)


def test_a_jax_adamw_checkpoint_resumes_in_the_port(adamw_crossed):
    run = adamw_crossed["port_from_jax"]
    assert run["start_epoch"] == 1 and len(run["epochs"]) == 1
    _assert_epoch_close(run["epochs"][0], adamw_crossed["jax_full"][1])
    # the restored count carried on: 3 steps of epoch 0, 3 of epoch 1
    assert int(run["state"]["['opt_state']['count']"]) == 6


def test_a_port_adamw_checkpoint_resumes_in_the_jax_trainer(adamw_crossed):
    jt, jax_from_port = adamw_crossed["jax_from_port"]
    assert jt.start_epoch == 1 and len(jax_from_port) == 1 and int(jt.state.step) == 6
    assert int(jax.device_get(jt.state.opt_state["count"])) == 6
    _assert_epoch_close(adamw_crossed["port_full"][1], jax_from_port[0])


def test_both_packages_stamp_the_decay_mask(adamw_crossed):
    root = adamw_crossed["root"]
    for d in ("jax", "port"):
        assert ckpt.read_meta(str(root / d / "ckpt_1.npz"))["adamw_decay_mask"] == "auto"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_another_decay_mask_is_refused_in_both_packages(adamw_crossed, writer):
    d = str(adamw_crossed["root"] / f"{writer}0")
    with pytest.raises(ckpt.ConfigMismatchError, match="adamw_decay_mask"):
        trainer.Trainer(TrainConfig(**_port(**{**ADAMW, "adamw_decay_mask": "all"},
                                            ckpt_dir=d, resume=True)))
    with pytest.raises(JaxConfigMismatchError, match="adamw_decay_mask"):
        _jax_trainer({**JAX_RUN, **ADAMW, "ckpt_dir": d, "resume": True,
                      "adamw_decay_mask": "all"})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_adamw_checkpoint_serves_with_f32_logits_bit_for_bit(adamw_crossed, writer):
    """``load_serving_state`` mirrors the AdamW entries into its template
    and drops them; the served logits equal an eval-mode forward of a
    module holding the file's own parameters."""
    path = str(adamw_crossed["root"] / writer / "ckpt_1.npz")
    loaded = load_serving_state(path, narrow_resnet(10, "cpu", 0))
    assert loaded["step"] == 6 and loaded["remapped"] == []
    served = bridge.load_jax_params(narrow_resnet(10, "cpu", 5), loaded["params"],
                                    loaded["bn_state"])
    tree = bridge.keystr_unflatten(ckpt.restore(path))
    assert set(tree["opt_state"]) == {"mu", "nu", "count"}
    want = bridge.load_jax_params(narrow_resnet(10, "cpu", 7), tree["params"], tree["bn_state"])
    payloads = np.random.default_rng(4).standard_normal((8, 32, 32, 3), dtype=np.float32)
    engine = ServingEngine(served, max_batch=8, device="cpu")
    for i, x in enumerate(payloads):
        engine.submit(x, id=i)
    done = engine.pump() + engine.drain()
    want.eval()
    with torch.inference_mode():
        logits = want(torch.from_numpy(payloads)).numpy()
    assert len(done) == 8 and all(r.ok for r in done)
    for r in done:
        np.testing.assert_array_equal(r.result, logits[r.id])


# -- ZeRO-1 + int8_ef, mid-epoch, across packages and worlds ------------------------

ELASTIC = dict(shard_weight_update=True, grad_compression="int8_ef", eval_every=0)
L_NARROW = 78002  # the narrow ResNet's parameters at 10 classes: 78004 at dp 4, 78002 at 2


def _jax_mesh(n):
    return mesh_lib.device_mesh([n], [mesh_lib.DATA_AXIS], jax.devices()[:n])


def _npz(path):
    with np.load(path) as z:
        return {k: np.array(z[k]) for k in z.files if k != "__meta__"}


def _rows_total(r1, n):
    return r1.reshape(n, -1)[:, :L_NARROW].sum(axis=0, dtype=np.float32)


@pytest.fixture(scope="module")
def zero1_crossed(tmp_path_factory):
    """A JAX ZeRO-1 + int8_ef run at dp 4 stopped by SIGTERM after step 0
    of epoch 1; the port's 2 ranks resuming it, then running the same
    preempted run of their own; the JAX trainer at dp 4 resuming that."""
    root = tmp_path_factory.mktemp("zero1")
    _register()
    try:
        jt = jax_trainer.Trainer(JaxConfig(**{**JAX_RUN, **ELASTIC, "ckpt_dir": str(root / "jax"),
                                              "fault_plan": "sigterm@epoch=1:step=0"}),
                                 mesh=_jax_mesh(4))
        with pytest.raises(jax_preemption.PreemptedError):
            jt.fit()
        # each resume below overwrites its ckpt_1 at its own world
        shutil.copy(root / "jax" / "ckpt_1.npz", root / "jax_snapshot.npz")
        jax_faults.clear()
        jax_preemption.clear()
        port = run_ranks(elastic_fit_rank, 2, [
            {**RUN, **ELASTIC, "ckpt_dir": str(root / "jax"), "resume": True,
             "log_file": str(root / "port_from_jax.jsonl")},
            {**RUN, **ELASTIC, "ckpt_dir": str(root / "port"),
             "fault_plan": "sigterm@epoch=1:step=0"}], timeout=180)
        shutil.copy(root / "port" / "ckpt_1.npz", root / "port_snapshot.npz")
        jax_counters.reset()
        jt2 = jax_trainer.Trainer(JaxConfig(**{**JAX_RUN, **ELASTIC, "ckpt_dir": str(root / "port"),
                                               "resume": True}), mesh=_jax_mesh(4))
        restored = jax.device_get(jt2.state)
        grows = jax_counters.get("elastic.grows")
        resharded = jax_counters.get("resume.resharded")
        resume_examples = jt2._resume_examples
        jax_last = jt2.fit()
    finally:
        jax_faults.clear()
        jax_preemption.clear()
    return dict(root=root, port=port, restored=restored, grows=grows, resharded=resharded,
                resume_examples=resume_examples, jax_last=jax_last)


def test_a_jax_zero1_ef_snapshot_resumes_in_the_port_at_another_world(zero1_crossed):
    root = zero1_crossed["root"]
    saved = _npz(str(root / "jax_snapshot.npz"))
    meta = ckpt.read_meta(str(root / "jax_snapshot.npz"))
    assert meta["elastic"]["dp"] == 4 and meta["mid_epoch_procs"] == 1
    assert saved["['opt_state']"].shape == (78004,)
    for rank in zero1_crossed["port"]:
        run = rank[0]
        assert run["start_epoch"] == 1 and run["resume_examples"] == 16
        assert run["counters"]["resume.resharded"] == 1
        got = run["restored"]
        for k in saved:
            if k.startswith("['params']") or k.startswith("['bn_state']"):
                np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
        np.testing.assert_array_equal(got["['opt_state']"], saved["['opt_state']"][:L_NARROW])
        np.testing.assert_array_equal(_rows_total(got["['ef']['r1']"], 2),
                                      _rows_total(saved["['ef']['r1']"], 4))
        # the offset (one global batch) and the steps after it: 1 and 2
        assert run["last"]["steps"] == 2 and np.isfinite(run["last"]["loss"])
    import json
    rec = [r for r in map(json.loads, open(root / "port_from_jax.jsonl"))
           if r.get("kind") == "resume"][-1]
    assert (rec["prev_dp"], rec["prev_procs"], rec["dp"], rec["resharded"]) == (4, 1, 2, True)


def test_a_port_zero1_ef_snapshot_resumes_in_the_jax_trainer_at_another_world(zero1_crossed):
    root = zero1_crossed["root"]
    path = str(root / "port_snapshot.npz")
    saved = _npz(path)
    meta = ckpt.read_meta(path)
    assert meta["elastic"]["dp"] == 2 and meta["mid_epoch_procs"] == 2
    assert meta["mid_epoch_examples"] == 16
    st = zero1_crossed["restored"]
    assert zero1_crossed["resharded"] == 1 and zero1_crossed["grows"] == 1
    assert zero1_crossed["resume_examples"] == 16
    for path_a, a in jax.tree_util.tree_flatten_with_path(st.params)[0]:
        key = jax.tree_util.keystr(path_a)
        np.testing.assert_array_equal(np.asarray(a), saved[f"['params']{key}"], err_msg=key)
    mom = np.asarray(st.opt_state)
    assert mom.shape == (78004,) and not mom[L_NARROW:].any()
    np.testing.assert_array_equal(mom[:L_NARROW], saved["['opt_state']"])
    np.testing.assert_array_equal(_rows_total(np.asarray(st.ef["r1"]), 4),
                                  _rows_total(saved["['ef']['r1']"], 2))
    # the JAX trainer counts the rest of the epoch from step 0: 3 steps
    last = zero1_crossed["jax_last"]
    assert last["steps"] == 3 and np.isfinite(last["loss"])
