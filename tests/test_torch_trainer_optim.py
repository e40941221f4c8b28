"""The optimizer dispatch and ``remat`` of the port's ``Trainer``
(``tpu_dist_torch/train/trainer.py::make_optimizer``), held against the JAX
``Trainer`` (``tpu_dist/train/trainer.py:670-723``).

* ``Trainer.fit`` with LARS (the large-batch recipe: ``lr_base_batch`` and
  ``warmup_epochs``) and ``remat``, from the JAX trainer's initial weights,
  nothing pinned (both take the C++ input pipeline): epoch by epoch
  against the JAX ``Trainer`` with the same options. (AdamW's run is in
  ``tests/test_torch_resume_cross.py``; LAMB's update is held to JAX's in
  ``tests/test_torch_optim.py``.)
* The JAX trainer's refusals: ``fused_optimizer`` with AdamW, LARS or LAMB
  raises ``ValueError``; LARS or LAMB with ``shard_weight_update`` meets
  the port's ``NotPortedError`` for ``shard_weight_update`` first; ``remat``
  with ``fused_epoch`` raises (the JAX fused path drops it). Its lines: the
  AdamW decay mask, the large-batch warning.
* An AdamW checkpoint without the decay-mask stamp resumes with a warning.
* An AdamW run crosses from the streaming path to the fused epoch: the
  step count carries on in the captured step.
"""

import jax
import numpy as np
import pytest
from torch_ranks import fit_run, free_port, narrow_resnet

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch import bridge, ckpt
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.train import trainer

RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=160,
           batch_size=16, epochs=2, steps_per_epoch=3, lr=0.02, log_every=1, eval_every=1,
           seed=0)
CASES = {
    "lars_remat": dict(optimizer="lars", lr_base_batch=8, warmup_epochs=2, remat=True),
}


def _record_epochs(t):
    epochs, inner = [], t.train_epoch

    def train_epoch(epoch, *a, **k):
        epochs.append(inner(epoch, *a, **k))
        return epochs[-1]

    t.train_epoch = train_epoch
    return epochs


@pytest.fixture(scope="module")
def runs():
    """Each case through both trainers, the port's from the JAX initial
    weights."""
    jax_trainer.register_model("narrow_resnet", lambda num_classes: ResNetDef(
        "basic", (1, 1, 1, 1), num_classes, widths=(8, 16, 32, 64)))
    trainer.register_model("narrow_resnet", narrow_resnet)
    out = {}
    for name, kw in CASES.items():
        jt = jax_trainer.Trainer(JaxConfig(**{**RUN, **kw}), mesh=mesh_lib.device_mesh(
            [1], [mesh_lib.DATA_AXIS], jax.devices()[:1]))
        params, bn_state = (jax.tree_util.tree_map(np.asarray, t)
                            for t in jax.device_get((jt.state.params, jt.state.bn_state)))
        jax_epochs = _record_epochs(jt)
        jt.fit()
        pt = trainer.Trainer(TrainConfig(**{**RUN, **kw}, device="cpu", port=free_port()))
        try:
            assert pt.input_pipeline.startswith("native")
            bridge.load_jax_resnet(pt.model, params, bn_state)
            port_epochs = _record_epochs(pt)
            pt.fit()
        finally:
            pt.close()
        out[name] = (jax_epochs, port_epochs)
    return out


# f32, the same 6 steps from the same weights on the same batches, as
# tests/test_torch_trainer.py: XLA's f32 gradients on the loader's
# zero-padded crops are up to ~1% off f64 on the CPU and the port's ~1e-6
# (ROADMAP Queue C); LARS's trust ratio divides by the gradient's norm, so
# that error moves each update by about as much as SGD's, and the losses by
# up to ~1e-3 relative: 2e-3. The hit counts agree but for near-ties: one
# example of 16 in a step, of 32 in the eval.
LOSS_TOL = dict(rtol=2e-3)


@pytest.mark.parametrize("name", list(CASES))
def test_fit_matches_the_jax_trainer_epoch_by_epoch(runs, name):
    jax_epochs, port_epochs = runs[name]
    assert len(jax_epochs) == len(port_epochs) == 2
    for ours, theirs in zip(port_epochs, jax_epochs):
        assert ours["steps"] == theirs["steps"] == 3
        for key in ("loss", "val_loss"):
            np.testing.assert_allclose(ours[key], theirs[key], **LOSS_TOL, err_msg=key)
        for key, n in (("acc1", 16), ("acc5", 16), ("val_top1", 32), ("val_top5", 32)):
            assert abs(ours[key] - theirs[key]) <= 100.0 / n + 1e-9, key


def _port(**kw):
    return TrainConfig(**{**RUN, "device": "cpu", "port": free_port(), **kw})


@pytest.mark.parametrize("optimizer", ["adamw", "lars", "lamb"])
def test_the_fused_sgd_kernel_is_sgds_only(optimizer):
    trainer.register_model("narrow_resnet", narrow_resnet)
    with pytest.raises(ValueError, match="fused"):
        trainer.Trainer(_port(optimizer=optimizer, fused_optimizer=True))


@pytest.mark.parametrize("optimizer", ["lars", "lamb"])
def test_a_trust_ratio_optimizer_with_zero1_is_refused(optimizer):
    """The JAX trainer's ValueError, word for word: the ZeRO-1 flat layout
    loses the per-layer norms LARS and LAMB need."""
    trainer.register_model("narrow_resnet", narrow_resnet)
    jax_trainer.register_model("narrow_resnet", lambda num_classes: ResNetDef(
        "basic", (1, 1, 1, 1), num_classes, widths=(8, 16, 32, 64)))
    with pytest.raises(ValueError) as ours:
        trainer.Trainer(_port(optimizer=optimizer, shard_weight_update=True))
    with pytest.raises(ValueError) as theirs:
        jax_trainer.Trainer(JaxConfig(**{**RUN, "optimizer": optimizer,
                                         "shard_weight_update": True}))
    assert str(ours.value) == str(theirs.value)
    assert "per-layer norms" in str(ours.value)


def test_remat_is_refused_on_the_fused_path():
    """JAX's ``make_fused_epoch`` has no ``remat`` and its trainer drops the
    flag (``tpu_dist/train/trainer.py:892-899``)."""
    assert trainer.FUSED_REFUSED["remat"][0] is False
    with pytest.raises(ValueError, match="remat=True.*--fused_epoch"):
        trainer.Trainer(_port(remat=True, fused_epoch=True, steps_per_epoch=None))


def test_the_dispatch_prints_the_jax_trainers_lines(capsys):
    trainer.register_model("narrow_resnet", narrow_resnet)
    for kw in (dict(optimizer="adamw", adamw_decay_mask="all"), dict(optimizer="lamb"),
               dict(optimizer="lars", lr_base_batch=8, warmup_epochs=1)):
        trainer.Trainer(_port(**kw)).close()
    out = capsys.readouterr().out
    assert "=> adamw decay_mask=all" in out
    assert out.count("WARNING: lamb without the full large-batch recipe") == 1
    assert "WARNING: lars" not in out


def test_an_adamw_checkpoint_without_the_stamp_resumes_with_a_warning(tmp_path, capsys):
    trainer.register_model("narrow_resnet", narrow_resnet)
    t = trainer.Trainer(_port(optimizer="adamw"))
    t.close()
    ckpt.save(str(tmp_path), t.state, 0)  # no adamw_decay_mask in its meta
    t = trainer.Trainer(_port(optimizer="adamw", ckpt_dir=str(tmp_path), resume=True))
    t.close()
    assert t.start_epoch == 1
    assert "predates the adamw_decay_mask stamp" in capsys.readouterr().out


def test_an_adamw_run_crosses_from_streaming_to_the_fused_epoch(tmp_path):
    kw = dict(optimizer="adamw", lr=1e-3, steps_per_epoch=None, synthetic_n=96,
              ckpt_dir=str(tmp_path), save_every=1, device="cpu")
    first = fit_run({**RUN, **kw, "epochs": 1, "port": free_port()})
    fused = fit_run({**RUN, **kw, "fused_epoch": True, "resume": True, "port": free_port()})
    assert first["error"] is None and fused["error"] is None and fused["start_epoch"] == 1
    # 96 images in steps of 16: 6 streaming steps, then 6 replayed ones
    assert int(first["state"]["['opt_state']['count']"]) == 6
    assert int(fused["state"]["['opt_state']['count']"]) == int(fused["state"]["['step']"]) == 12
    assert np.isfinite(fused["epochs"][0]["loss"])
    assert ckpt.read_meta(str(tmp_path / "ckpt_1.npz"))["adamw_decay_mask"] == "auto"
