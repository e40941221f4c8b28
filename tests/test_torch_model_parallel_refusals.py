"""The trainer's refusals around ``--tp``, ``--ep`` and ``--moe_top_k``,
each held to the JAX ``Trainer``'s own message on the same configuration
(``tpu_dist/train/trainer.py:267-276``, ``:422-493``, ``:766-777``): the
combinations other than sp+tp and pp+tp, a model without a tp or ep
branch, heads or experts that do not divide over the group, the fused
epoch, ZeRO-1 and the quantized wires, a ``moe_top_k`` the model cannot
take, an EP batch that does not divide over every device and
``--device_metrics``; ``--pp`` with ``--fsdp`` is refused as JAX refuses
it, and the sharded format runs under ``--pp`` (``pp``'s other refusals:
``test_torch_pipeline_refusals.py``; FSDP's: ``test_torch_fsdp_trainer.py``)."""

import json

import jax
import numpy as np
import pytest
from torch_ranks import free_port, fsdp_fit_rank, run_ranks, trainer_errors_rank

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.train import trainer as jax_trainer

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


@pytest.mark.parametrize("flag", ["fsdp", "sharded_ckpt"])
def test_pp_with_fsdp_or_the_sharded_format(flag, tmp_path):
    """``--pp`` with ``--fsdp`` is the JAX trainer's ``ValueError``; with
    ``--sharded_ckpt`` a pipelined run saves each stage's stacked rows as
    JAX's pieces (the manifest's global shapes are the full depth's) and
    resumes bit for bit."""
    pp = dict(BASE, model="vit_pp_tiny", pp=2)
    if flag == "fsdp":
        want = _jax_error(dict(pp, fsdp=True), 1, None)
        assert want is not None and want.startswith("ValueError: fsdp composes with --tp")
        got = trainer_errors_rank(0, 1, [dict(pp, fsdp=True, device="cpu", port=free_port())])
        assert got == [want]
        return
    cfg = dict(pp, steps_per_epoch=2, save_every=1, eval_every=1, sharded_ckpt=True,
               ckpt_dir=str(tmp_path), device="cpu", port=free_port())
    r = run_ranks(fsdp_fit_rank, 2, [cfg], timeout=120)[0][0]
    assert r["error"] is None and r["start"] == 1
    for k, v in r["state"].items():
        np.testing.assert_array_equal(r["resumed"][k], v, err_msg=k)
    with open(tmp_path / "ckpt_0.manifest.json") as f:
        shapes = json.load(f)["shapes"]
    assert shapes == {k: list(np.shape(v)) for k, v in r["state"].items()}
    assert shapes["['params']['blocks']['qkv']['w']"][0] == 4  # vit_pp_tiny's depth, stacked
