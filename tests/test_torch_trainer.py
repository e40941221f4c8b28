"""The port's trainer (``tpu_dist_torch.train.trainer.Trainer``) and CLI held
against the JAX package's ``Trainer``.

* ``Trainer.fit`` on a world of one CPU rank (gloo), from the JAX trainer's
  bridged initial state, against the JAX ``Trainer`` on a one-device mesh:
  the same narrow ResNet registered in both, synthetic data, 2 epochs of 3
  steps each and an eval after each; the per-epoch train loss and accuracy
  and the eval top-1/top-5/loss. Both trainers' augmentation is held to
  the numpy path (the C++ pipeline both take by default is held apart, in
  ``tests/test_torch_native_pipeline.py``).
* Every flag of ``UNPORTED`` raises ``NotPortedError`` naming its ROADMAP
  item; ``sp`` and ``sp_mode`` train.
* ``python -m tpu_dist_torch.cli.distributed_mp --device cpu`` with 2 ranks.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from torch_ranks import child_env, free_port, narrow_resnet, run_ranks, seq_fit_rank

import tpu_dist.data.native as jax_native
import tpu_dist_torch.data.native as port_native
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
    mp.setattr(port_native, "_load", lambda: None)
    try:
        jt = jax_trainer.Trainer(
            JaxConfig(**RUN), mesh=mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS],
                                                       jax.devices()[:1]))
        params, bn_state = (jax.tree_util.tree_map(np.asarray, t)
                            for t in jax.device_get((jt.state.params, jt.state.bn_state)))
        jax_epochs = _record_epochs(jt)
        jt.fit()
        pt = trainer.Trainer(TrainConfig(**RUN, device="cpu", port=free_port()))
        try:
            bridge.load_jax_resnet(pt.model, params, bn_state)
            port_epochs = _record_epochs(pt)
            pt.fit()
        finally:
            pt.close()
    finally:
        mp.undo()
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
# crash_dir is ported and runs in tests/test_torch_trainer_forensics.py;
# fault_plan runs in tests/test_torch_faults.py, and heartbeat_file,
# metrics_file, metrics_port and alert_rules in
# tests/test_torch_trainer_telemetry.py; optimizer (adamw, lars, lamb) runs
# in tests/test_torch_trainer_optim.py and tests/test_torch_resume_cross.py,
# and remat in tests/test_torch_remat.py and
# tests/test_torch_trainer_optim.py; shard_weight_update, rs_ag_chunks,
# grad_compression and quant_chunk run below and in
# tests/test_torch_elastic_trainer.py and test_torch_resume_cross.py;
# device_metrics, anomaly_action, straggler_threshold, profile_dir,
# profile_trigger and profile_steps run in tests/test_torch_device_stats.py,
# test_torch_straggler.py, test_torch_profile.py and
# test_torch_trainer_health.py; trace_file, memory_check and
# hbm_budget_bytes in tests/test_torch_memory_ledger.py and
# test_torch_export_trace.py; fsdp and sharded_ckpt in
# tests/test_torch_fsdp*.py and test_torch_*sharded_ckpt.py.
UNPORTED_CASES = (
    ("tensorboard_dir", "tb", "Queue A 6"),
    ("auto_shard", "plan", "Queue A 6"),
    ("debug_replica_check", True, "Queue A 6"), ("tune_report", "t.json", "Queue A 6"),
    ("compile_cache_dir", "cache", "No port owed"),
)


@pytest.mark.parametrize("flag,value,queue", UNPORTED_CASES, ids=lambda v: str(v))
def test_unported_flags_raise_a_typed_error(flag, value, queue):
    with pytest.raises(step.NotPortedError, match=flag) as info:
        trainer.Trainer(TrainConfig(**{**RUN, flag: value}, device="cpu", port=free_port()))
    assert info.value.flag == flag and queue in str(info.value)


# tp, ep and moe_top_k, ported with tensor and expert parallelism (they
# raised NotPortedError before): each trains on 2 gloo ranks (parity with the
# JAX trainer: tests/test_torch_model_parallel_trainer.py,
# test_torch_model_parallel_fit.py and test_torch_expert_parallel_trainer.py)
MP_CASES = (("tp", dict(model="vit_tiny", tp=2)), ("ep", dict(model="vit_moe_tiny", ep=2)),
            ("moe_top_k", dict(model="vit_moe_tiny", moe_top_k=2)))


@pytest.fixture(scope="module")
def mp_fits():
    from torch_ranks import mp_fit_rank  # noqa: PLC0415

    run = dict(num_classes=10, dataset="synthetic", synthetic_n=160, batch_size=16, epochs=1,
               steps_per_epoch=2, log_every=1, eval_every=1, device="cpu")
    return run_ranks(mp_fit_rank, 2, [dict(run, **kw) for _, kw in MP_CASES], None,
                     timeout=120)


@pytest.mark.parametrize("i", range(len(MP_CASES)), ids=[f for f, _ in MP_CASES])
def test_the_tp_ep_and_moe_top_k_flags_train(mp_fits, i):
    flag = MP_CASES[i][0]
    for fits in mp_fits:
        (epoch,) = fits[i]["epochs"]
        assert epoch["steps"] == 2 and np.isfinite(epoch["loss"]) and "val_top1" in epoch
        assert fits[i]["n_data"] == (2 if flag == "moe_top_k" else 1)


# sp and sp_mode, ported with sequence parallelism (they raised
# NotPortedError before): vit_tiny trains with each on 4 gloo ranks, a
# [2, 2] mesh, with the loaders' own crops (parity with the JAX trainer on
# a [2, 2] mesh: tests/test_torch_seq_parallel_trainer.py and _fit.py)
SP_CASES = (("sp", dict(sp=2)), ("sp_mode", dict(sp=2, sp_mode="ulysses")))


@pytest.fixture(scope="module")
def sp_fits():
    run = dict(model="vit_tiny", num_classes=10, dataset="synthetic", synthetic_n=160,
               batch_size=16, epochs=1, steps_per_epoch=2, log_every=1, eval_every=1,
               device="cpu")
    return run_ranks(seq_fit_rank, 4, [dict(run, **kw) for _, kw in SP_CASES], None, True,
                     timeout=120)


@pytest.mark.parametrize("i", range(len(SP_CASES)), ids=[f for f, _ in SP_CASES])
def test_the_sp_flags_train(sp_fits, i):
    for fits in sp_fits:
        fit = fits[i]
        assert fit["n_data"] == 2 and fit["batches"] == (8, 4)
        (epoch,) = fit["epochs"]
        assert epoch["steps"] == 2 and np.isfinite(epoch["loss"]) and "val_top1" in epoch


def test_a_seq_group_draws_one_batch_and_its_crops(sp_fits):
    """The train stream is keyed by the data index: the two ranks of a seq
    group draw the same examples with the same crops (else each would
    differentiate another loss and the seq mean would be wrong), the two
    data rows different ones."""
    (x0, y0), (x1, y1), (x2, y2), (x3, y3) = (f[0]["first_batch"] for f in sp_fits)
    assert np.array_equal(x0, x1) and np.array_equal(y0, y1)
    assert np.array_equal(x2, x3) and np.array_equal(y2, y3)
    assert not np.array_equal(x0, x2)


# the flags ported with ZeRO-1 and the compressed reduce, one case each
PORTED_CASES = (
    ("grad_compression", dict(grad_compression="bf16")),
    ("shard_weight_update", dict(shard_weight_update=True)),
    ("quant_chunk", dict(grad_compression="int8", quant_chunk=64)),
    ("rs_ag_chunks", dict(shard_weight_update=True, rs_ag_chunks=2)),
    ("grad_compression-fused_epoch", dict(grad_compression="int8_ef", fused_epoch=True)),
)


@pytest.mark.parametrize("flag,kw", PORTED_CASES, ids=[f for f, _ in PORTED_CASES])
def test_the_zero1_and_compression_flags_train(flag, kw):
    trainer.register_model("narrow_resnet", narrow_resnet)
    steps = None if kw.get("fused_epoch") else 1  # a fused epoch runs all its 10 steps
    t = trainer.Trainer(TrainConfig(**{**RUN, **kw, "steps_per_epoch": steps, "eval_every": 0},
                                    device="cpu", port=free_port()))
    try:
        last = t.fit(1)
    finally:
        t.close()
    assert t.state.step == (steps or 10) and np.isfinite(last["loss"])
    if kw.get("shard_weight_update"):
        # this rank's shard of the flat momentum: the whole of it at one rank
        assert t.state.layout is not None and t.state.opt_state.shape == (t.state.layout.L,)
    else:
        assert isinstance(t.state.opt_state, list)
        assert (t.state.layout is not None) == (kw["grad_compression"] == "int8_ef")


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
    env = child_env(PYTHONPATH=ROOT)
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
