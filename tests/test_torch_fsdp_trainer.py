"""``--fsdp`` through the port's ``Trainer`` (``tpu_dist/train/trainer.py:
373-421``, ``:838-860``, ``:1208-1224``, ``:2385-2445``), as
``tests/test_fsdp.py:203-366`` drives the JAX one: fit and resume at 2 gloo
ranks of a ResNet under ``--fsdp`` with the plain format (the shards
gathered to rank 0), the sharded format and its async writer, and ``vit_tiny
--tp 2 --optimizer adamw --fsdp --sharded_ckpt`` at 4 ranks; each resumes at
the next epoch with the saved state (rtol 1e-6; it is bit for bit), as do
the sharded format's runs under ``--ep 2`` and ZeRO-1. Every refusal and warning of ``--fsdp`` is the JAX trainer's, word for word, and
a directory of the other format raises the loud ``ValueError``."""

import os

import numpy as np
import pytest
from torch_ranks import (free_port, fsdp_fit_rank, layout_state, narrow_resnet, run_ranks,
                         trainer_errors_rank)

from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch import ckpt
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.train import trainer

RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=64,
           batch_size=16, epochs=1, steps_per_epoch=2, lr=0.05, log_every=1, eval_every=1,
           seed=0, device="cpu", fsdp=True, save_every=1)
VARIANTS = {"plain": {}, "sharded": dict(sharded_ckpt=True),
            "sharded-async": dict(sharded_ckpt=True, async_ckpt=True),
            "no-fsdp": dict(fsdp=False)}


@pytest.fixture(scope="module")
def resnet_fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp_fit")
    cfgs = [dict(RUN, **kw, ckpt_dir=str(root / name), port=free_port())
            for name, kw in VARIANTS.items()]
    out = run_ranks(fsdp_fit_rank, 2, cfgs, timeout=150)[0]
    return root, dict(zip(VARIANTS, out))


@pytest.mark.parametrize("name", [n for n in VARIANTS if n != "no-fsdp"])
def test_resnet_fit_and_resume_under_fsdp(resnet_fits, name):
    root, fits = resnet_fits
    r = fits[name]
    assert r["error"] is None and len(r["losses"]) == 2
    assert all(np.isfinite(r["losses"]))
    assert r["start"] == 1
    for k, v in r["state"].items():
        np.testing.assert_allclose(r["resumed"][k], v, rtol=1e-6, err_msg=k)
    names = sorted(os.listdir(root / name))
    if name == "plain":
        assert names == ["ckpt_0.npz", "ckpt_best.npz"]  # the shards gathered whole
    else:
        assert "ckpt_0.manifest.json" in names and "ckpt_0.shard1of2.npz" in names
        assert not any(n.endswith(".npz") and ".shard" not in n for n in names)
        assert ckpt.verify_sharded(str(root / name / "ckpt_0.manifest.json"))["epoch"] == 0


def test_vit_tiny_tp2_adamw_fsdp_sharded_fit_and_resume(tmp_path):
    cfg = dict(RUN, model="vit_tiny", tp=2, optimizer="adamw", lr=0.01, batch_size=32,
               synthetic_n=128, sharded_ckpt=True, ckpt_dir=str(tmp_path), port=free_port())
    r = run_ranks(fsdp_fit_rank, 4, [cfg], timeout=150)[0][0]
    assert r["error"] is None and all(np.isfinite(r["losses"])) and r["start"] == 1
    assert set(r["state"]) >= {"['opt_state']['mu']['blocks'][0]['qkv']['w']",
                               "['opt_state']['count']"}
    for k, v in r["state"].items():
        np.testing.assert_allclose(r["resumed"][k], v, rtol=1e-6, err_msg=k)
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("ckpt_0.shard")) == [
        f"ckpt_0.shard{p}of4.npz" for p in range(4)]


BASE = dict(dataset="synthetic", synthetic_n=160, batch_size=16, num_classes=10, epochs=1,
            fsdp=True)
REFUSALS = {
    "sp": dict(model="vit_tiny", sp=2),
    "ep": dict(model="vit_moe_tiny", ep=2),
    "pp": dict(model="vit_pp_tiny", pp=2),
    "zero1": dict(model="resnet18", shard_weight_update=True),
    "fused_epoch": dict(model="resnet18", fused_epoch=True),
    "fused_optimizer": dict(model="resnet18", fused_optimizer=True),
    "debug_replica_check": dict(model="resnet18", debug_replica_check=True),
    "flash_attention": dict(model="vit_tiny", flash_attention=True),
}


@pytest.fixture(scope="module")
def port_refusals():
    cfgs = [dict(BASE, **kw, device="cpu", port=free_port()) for kw in REFUSALS.values()]
    return dict(zip(REFUSALS, trainer_errors_rank(0, 1, cfgs)))


@pytest.mark.parametrize("name", list(REFUSALS))
def test_every_fsdp_refusal_is_the_jax_trainers(port_refusals, name):
    try:
        jax_trainer.Trainer(JaxConfig(**BASE, **REFUSALS[name]))
        want = None
    except Exception as e:  # the refusal under test
        want = f"{type(e).__name__}: {e}"
    assert want is not None and want.startswith("ValueError: "), want
    assert port_refusals[name] == want


def test_the_fsdp_warnings_are_the_jax_trainers(capsys):
    kw = dict(BASE, model="vit_tiny", synthetic_n=32, sync_bn=False, grad_compression="bf16")
    trainer.fsdp_warnings(TrainConfig(**kw, device="cpu", port=free_port()))
    port = [line for line in capsys.readouterr().out.splitlines() if "under --fsdp" in line]
    jax_trainer.Trainer(JaxConfig(**kw))
    want = [line for line in capsys.readouterr().out.splitlines() if "under --fsdp" in line]
    assert len(port) == 2 and port == want


def test_a_dir_of_the_other_format_is_refused_loudly(tmp_path):
    trainer.register_model("narrow_resnet", narrow_resnet)
    ckpt.save_sharded(str(tmp_path), layout_state("dp"), 0)
    with pytest.raises(ValueError, match="holds checkpoints in the sharded format") as info:
        trainer.Trainer(TrainConfig(**{**RUN, "fsdp": False}, ckpt_dir=str(tmp_path),
                                    resume=True, port=free_port()))
    assert "flip --sharded_ckpt to match" in str(info.value)



def test_the_ledger_holds_a_ranks_shards_and_the_flops_are_the_plain_steps(resnet_fits):
    """Under ``--fsdp`` the static ledger's rows are a rank's shard sizes,
    with its sharded leaves counted, and the first step's FLOPs are the
    plain step's (``obs/memory.py``, ``obs/costmodel.py``)."""
    fits = resnet_fits[1]
    plain, sharded = fits["no-fsdp"], fits["plain"]
    assert plain["ledger"]["sharded_leaves"] == 0 < sharded["ledger"]["sharded_leaves"]
    assert sharded["ledger"]["bytes_total"] == plain["ledger"]["bytes_total"]
    assert sharded["ledger"]["bytes_per_device"] < 0.6 * plain["ledger"]["bytes_per_device"]
    assert sharded["cost"]["flops_per_step"] == plain["cost"]["flops_per_step"] > 0


def test_the_sharded_format_under_ep_and_zero1(tmp_path):
    """``--sharded_ckpt`` beside ``--ep 2`` (a MoE ViT's expert slabs from
    each expert rank) and beside ZeRO-1 (the flat momentum written whole
    from rank 0): each fit resumes at the next epoch with its state bit for
    bit."""
    base = dict(RUN, fsdp=False, sharded_ckpt=True, synthetic_n=160)
    cfgs = [dict(base, model="vit_moe_tiny", ep=2, ckpt_dir=str(tmp_path / "ep"),
                 port=free_port()),
            dict(base, shard_weight_update=True, ckpt_dir=str(tmp_path / "zero1"),
                 port=free_port())]
    for r in run_ranks(fsdp_fit_rank, 2, cfgs, timeout=150)[0]:
        assert r["error"] is None and r["start"] == 1 and all(np.isfinite(r["losses"]))
        for k, v in r["state"].items():
            np.testing.assert_array_equal(r["resumed"][k], v, err_msg=k)
    assert "ckpt_0.shard1of2.npz" in os.listdir(tmp_path / "ep")
