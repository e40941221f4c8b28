"""The trainer's refusals around ``--tp``, ``--ep`` and ``--moe_top_k``,
each held to the JAX ``Trainer``'s own message on the same configuration
(``tpu_dist/train/trainer.py:267-276``, ``:422-493``, ``:766-777``): the
combinations other than sp+tp and pp+tp, a model without a tp or ep
branch, heads or experts that do not divide over the group, the fused
epoch, ZeRO-1 and the quantized wires, a ``moe_top_k`` the model cannot
take, an EP batch that does not divide over every device and
``--device_metrics``. ``fsdp`` and ``sharded_ckpt`` still raise
``NotPortedError`` with their ROADMAP labels (``pp``'s refusals:
``test_torch_pipeline_refusals.py``)."""

import jax
import pytest
from torch_ranks import free_port, run_ranks, trainer_errors_rank

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.train import trainer
from tpu_dist_torch.train.step import NotPortedError

BASE = dict(dataset="synthetic", synthetic_n=160, batch_size=16, num_classes=10, epochs=1)
TINY, MOE = dict(BASE, model="vit_tiny"), dict(BASE, model="vit_moe_tiny")

# name -> (config, world: the port's ranks and the JAX mesh's devices,
# the JAX mesh's second axis)
CASES = {
    "sp+ep": (dict(MOE, sp=2, ep=2), 1, None),
    "tp+ep": (dict(MOE, tp=2, ep=2), 1, None),
    "tp-resnet": (dict(BASE, model="resnet18", num_classes=100, dataset="synthetic", tp=2), 2,
                  "model"),
    "tp-heads": (dict(TINY, tp=3), 3, "model"),
    "tp-fused": (dict(TINY, tp=2, fused_epoch=True), 1, None),
    "tp-zero1": (dict(TINY, tp=2, shard_weight_update=True), 1, None),
    "tp-int8": (dict(TINY, tp=2, grad_compression="int8"), 1, None),
    "moe_top_k-0": (dict(MOE, moe_top_k=0), 1, None),
    "moe_top_k-vit": (dict(TINY, moe_top_k=2), 1, None),
    "moe_top_k-9": (dict(MOE, moe_top_k=9), 1, None),
    "ep-resnet": (dict(BASE, model="resnet18", num_classes=100, ep=2), 2, "expert"),
    "ep-experts": (dict(MOE, ep=3), 3, "expert"),
    "ep-fused": (dict(MOE, ep=2, fused_epoch=True), 1, None),
    "ep-zero1": (dict(MOE, ep=2, shard_weight_update=True), 1, None),
    "ep-batch": (dict(MOE, ep=2, batch_size=15), 2, "expert"),
    "tp-device_metrics": (dict(TINY, tp=2, device_metrics=True), 1, None),
    "ep-device_metrics": (dict(MOE, ep=2, device_metrics=True), 1, None),
}


def _jax_error(cfg, world, second):
    """``"TypeName: message"`` the JAX trainer raises on ``cfg``, on a
    ``[1, world]`` mesh of ``[data, second]`` (or its default mesh)."""
    mesh = (mesh_lib.device_mesh([1, world], ["data", second], jax.devices()[:world])
            if second else None)
    try:
        jax_trainer.Trainer(JaxConfig(**cfg), mesh=mesh)
    except Exception as e:  # the refusal under test
        return f"{type(e).__name__}: {e}"
    return None


@pytest.fixture(scope="module")
def port_errors():
    out = {}
    for world in (1, 2, 3):
        names = [n for n, (_, w, _) in CASES.items() if w == world]
        cfgs = [dict(CASES[n][0], device="cpu") for n in names]
        if world == 1:
            errs = trainer_errors_rank(0, 1, [dict(c, port=free_port()) for c in cfgs])
        else:
            errs = run_ranks(trainer_errors_rank, world, cfgs, timeout=90)[0]
        out.update(zip(names, errs))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_the_refusal_is_the_jax_trainers(port_errors, name):
    cfg, world, second = CASES[name]
    want = _jax_error(cfg, world, second)
    assert want is not None and want.startswith("ValueError: "), want
    assert port_errors[name] == want


@pytest.mark.parametrize("kw,flag", [
    (dict(TINY, fsdp=True), "fsdp"), (dict(TINY, sharded_ckpt=True), "sharded_ckpt"),
], ids=["fsdp", "sharded_ckpt"])
def test_pp_fsdp_and_the_sharded_format_still_wait(kw, flag):
    with pytest.raises(NotPortedError, match=flag) as info:
        trainer.Trainer(TrainConfig(**kw, device="cpu", port=free_port()))
    assert info.value.flag == flag and info.value.queue == trainer.UNPORTED[flag][1]
