"""The port's trainer (``tpu_dist_torch.train.trainer.Trainer``) and CLI held
against the JAX package's ``Trainer``.

* ``Trainer.fit`` on a world of one CPU rank (gloo), from the JAX trainer's
  bridged initial state, against the JAX ``Trainer`` on a one-device mesh:
  the same narrow ResNet registered in both, synthetic data, 2 epochs of 3
  steps each and an eval after each; the per-epoch train loss and accuracy
  and the eval top-1/top-5/loss. The JAX trainer's augmentation is held to
  its numpy path (its C++ pipeline draws crops from another RNG stream).
* Every flag of ``UNPORTED`` raises ``NotPortedError`` naming its ROADMAP
  item.
* ``python -m tpu_dist_torch.cli.distributed_mp --device cpu`` with 2 ranks.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from torch_ranks import free_port

import tpu_dist.data.native as jax_native
from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch import bridge
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.nn import resnet
from tpu_dist_torch.train import step, trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(block="basic", stage_blocks=(1, 1, 1, 1), widths=(8, 16, 32, 64))
RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=160,
           batch_size=16, epochs=2, steps_per_epoch=3, lr=0.02, log_every=1, eval_every=1,
           seed=0)


def _record_epochs(t):
    """Wrap ``t.train_epoch`` to keep each epoch's dict (``fit`` adds the
    eval numbers to the same dict)."""
    epochs, inner = [], t.train_epoch

    def train_epoch(epoch, *a, **k):
        epochs.append(inner(epoch, *a, **k))
        return epochs[-1]

    t.train_epoch = train_epoch
    return epochs


@pytest.fixture(scope="module")
def runs():
    jax_trainer.register_model("narrow_resnet", lambda num_classes: ResNetDef(
        NARROW["block"], NARROW["stage_blocks"], num_classes, widths=NARROW["widths"]))
    trainer.register_model("narrow_resnet", lambda num_classes, device, seed: resnet.ResNet(
        NARROW["block"], NARROW["stage_blocks"], num_classes, widths=NARROW["widths"],
        device=device, seed=seed))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_load", lambda: None)
    try:
        jt = jax_trainer.Trainer(
            JaxConfig(**RUN), mesh=mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS],
                                                       jax.devices()[:1]))
        params, bn_state = (jax.tree_util.tree_map(np.asarray, t)
                            for t in jax.device_get((jt.state.params, jt.state.bn_state)))
        jax_epochs = _record_epochs(jt)
        jt.fit()
    finally:
        mp.undo()
    pt = trainer.Trainer(TrainConfig(**RUN, device="cpu", port=free_port()))
    try:
        bridge.load_jax_resnet(pt.model, params, bn_state)
        port_epochs = _record_epochs(pt)
        pt.fit()
    finally:
        pt.close()
    return jax_epochs, port_epochs


# f32, the same 6 steps at lr 0.02 from the same weights on the same
# batches. The loader's random crops pad with zeros, and on such inputs the
# JAX step's f32 gradients on the CPU are off by up to ~1% (relative L2 per
# leaf) from an f64 evaluation, while the port's agree with it to ~1e-6
# (test_torch_resnet.py::test_f32_gradients_on_cropped_inputs_match_f64).
# Six such updates move the loss (~2.3) by up to ~8e-4 relative, the eval
# loss by less: 2e-3 relative. The hit counts of logits that close agree
# but for near-ties: at most one example of the 16 in a step, of the 32 in
# the eval.
LOSS_TOL = dict(rtol=2e-3)


def test_fit_matches_the_jax_trainer_epoch_by_epoch(runs):
    jax_epochs, port_epochs = runs
    assert len(jax_epochs) == len(port_epochs) == 2
    for ours, theirs in zip(port_epochs, jax_epochs):
        assert ours["steps"] == theirs["steps"] == 3
        for key in ("loss", "val_loss"):
            np.testing.assert_allclose(ours[key], theirs[key], **LOSS_TOL, err_msg=key)
        for key, n in (("acc1", 16), ("acc5", 16), ("val_top1", 32), ("val_top5", 32)):
            assert abs(ours[key] - theirs[key]) <= 100.0 / n + 1e-9, key


def test_epoch_dict_has_the_jax_keys(runs):
    jax_epochs, port_epochs = runs
    # mfu needs the JAX cost model of a known chip; neither side has one here
    assert set(port_epochs[-1]) == set(jax_epochs[-1]) - {"mfu"}


# One case for every flag of trainer.UNPORTED. The checkpoint/resume and
# history flags (ckpt_dir, resume, keep_last_ckpts, mid_epoch_save_every,
# async_ckpt, auto_recover, log_file, per_host_log) are ported and run in
# tests/test_torch_resume.py::test_the_checkpoint_and_history_flags_work_through_fit;
# fused_epoch is ported and runs in tests/test_torch_fused_trainer.py;
# crash_dir is ported and runs in tests/test_torch_trainer_forensics.py.
UNPORTED_CASES = (
    ("tensorboard_dir", "tb", "Queue A 6"),
    ("fsdp", True, "Queue A 6"),
    ("sp", 2, "Queue A 3"), ("sp_mode", "ulysses", "Queue A 3"), ("tp", 2, "Queue A 6"),
    ("ep", 2, "Queue A 6"), ("pp", 2, "Queue A 6"), ("fault_plan", "x", "Queue A 6"),
    ("profile_dir", "prof", "Queue A 6"), ("profile_steps", "1:3", "Queue A 6"),
    ("profile_trigger", "auto", "Queue A 6"), ("auto_shard", "plan", "Queue A 6"),
    ("optimizer", "adamw", "Queue A 6"), ("grad_compression", "bf16", "Queue A 6"),
    ("shard_weight_update", True, "Queue A 6"), ("anomaly_action", "warn", "Queue A 6"),
    ("straggler_threshold", 1.5, "Queue A 6"),
    ("sharded_ckpt", True, "Queue A 6"), ("remat", True, "Queue A 6"),
    ("quant_chunk", 64, "Queue A 6"), ("rs_ag_chunks", 2, "Queue A 6"),
    ("device_metrics", True, "Queue A 6"), ("pp_microbatches", 4, "Queue A 6"),
    ("pp_interleave", 2, "Queue A 6"), ("moe_top_k", 2, "Queue A 6"),
    ("trace_file", "trace.json", "Queue A 6"), ("heartbeat_file", "hb.json", "Queue A 6"),
    ("metrics_file", "m.prom", "Queue A 6"), ("metrics_port", 9100, "Queue A 6"),
    ("alert_rules", "rules.json", "Queue A 6"),
    ("memory_check", "warn", "Queue A 6"), ("hbm_budget_bytes", 2 ** 30, "Queue A 6"),
    ("debug_replica_check", True, "Queue A 6"), ("tune_report", "t.json", "Queue A 6"),
    ("compile_cache_dir", "cache", "No port owed"),
)


@pytest.mark.parametrize("flag,value,queue", UNPORTED_CASES, ids=lambda v: str(v))
def test_unported_flags_raise_a_typed_error(flag, value, queue):
    with pytest.raises(step.NotPortedError, match=flag) as info:
        trainer.Trainer(TrainConfig(**{**RUN, flag: value}, device="cpu", port=free_port()))
    assert info.value.flag == flag and queue in str(info.value)


def test_the_refusal_cases_cover_every_unported_flag():
    assert sorted(flag for flag, _, _ in UNPORTED_CASES) == sorted(trainer.UNPORTED)


def test_every_unported_flag_has_a_config_field_at_its_default():
    cfg = TrainConfig()
    for flag, (default, queue) in trainer.UNPORTED.items():
        assert getattr(cfg, flag) == default, flag
        assert queue.startswith("Queue A "), flag


def test_backend_must_fit_the_device():
    from tpu_dist_torch.cli.train import parse  # noqa: PLC0415

    assert parse(["--device", "cpu", "--backend", "gloo"]).device == "cpu"
    for argv in (["--device", "cpu", "--backend", "nccl"], ["--backend", "xla"]):
        with pytest.raises(SystemExit):
            parse(argv)


def test_distributed_mp_cli_on_two_cpu_ranks():
    """Two spawned gloo ranks train full-width ResNet-18 for 2 steps and
    evaluate; only rank 0 prints, so one epoch line."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.cli.distributed_mp", "--device", "cpu",
         "--num_processes", "2", "--port", str(free_port()), "--dataset", "synthetic",
         "--synthetic_n", "32", "--batch_size", "8", "--epochs", "1",
         "--steps_per_epoch", "2", "--log_every", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert sum(line.startswith("Epoch 0 done") for line in lines) == 1, proc.stdout
    assert sum(line.startswith("tpu_dist_torch: model=resnet18 ranks=2") for line in lines) == 1
    assert sum(line.startswith(" * Acc@1") for line in lines) == 1
