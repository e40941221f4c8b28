"""The port trainer's refusals of ``--sp``, with the JAX trainer's messages
(``tpu_dist/train/trainer.py:326-380``): a model with no seq branch, heads
or patch tokens that do not divide over ``sp``, the fused epoch, fsdp, an
unknown ``sp_mode``, ZeRO-1 with ``tp`` (ZeRO-1 itself runs under ``sp``);
and on 2 gloo ranks a batch or a world that does not divide, the int8 wire,
and LARS under ZeRO-1 (whose flat layout loses its per-layer norms).
"""

import pytest
from torch_ranks import free_port, run_ranks, trainer_errors_rank

from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.train import trainer

FIT_RUN = dict(model="vit_tiny", num_classes=10, dataset="synthetic", synthetic_n=160,
               batch_size=16, epochs=2, steps_per_epoch=2, lr=0.05, log_every=1,
               eval_every=1, seed=0, sp=2)

REFUSALS = (
    (dict(model="resnet18", num_classes=100, dataset="synthetic", synthetic_n=512, sp=2),
     ValueError, "does not support sequence parallelism"),
    (dict(FIT_RUN, sp=3, sp_mode="ulysses"), ValueError,
     r"sp_mode='ulysses' needs per-shard heads \(4\) divisible by sp \(3\)"),
    (dict(FIT_RUN, sp=3), ValueError, "model has 64 patch tokens, not divisible by sp=3"),
    (dict(FIT_RUN, fused_epoch=True, steps_per_epoch=None), ValueError,
     "sp > 1 is not supported with fused_epoch"),
    (dict(FIT_RUN, fsdp=True), ValueError, "fsdp composes with --tp"),
    (dict(FIT_RUN, sp_mode="tree"), ValueError, "sp_mode must be 'ring' or 'ulysses'"),
    (dict(FIT_RUN, shard_weight_update=True, tp=2), ValueError,
     "tp > 1 is incompatible with fused_epoch / zero1"),
)


@pytest.mark.parametrize("kw,err,match", REFUSALS,
                         ids=["resnet18", "heads", "tokens", "fused_epoch", "fsdp", "sp_mode",
                              "zero1"])
def test_the_trainer_refuses_what_jax_refuses(kw, err, match):
    with pytest.raises(err, match=match):
        trainer.Trainer(TrainConfig(**kw, device="cpu", port=free_port()))


def test_the_refusals_that_need_ranks():
    """On 2 ranks: a batch that does not divide over data x seq, a world
    that does not divide over sp, the int8 wire under sp, and LARS under
    ZeRO-1 (which JAX refuses under sp as without it)."""
    cfgs = [dict(FIT_RUN, batch_size=15, device="cpu"), dict(FIT_RUN, sp=4, device="cpu"),
            dict(FIT_RUN, grad_compression="int8", device="cpu"),
            dict(FIT_RUN, shard_weight_update=True, optimizer="lars", device="cpu")]
    errors = run_ranks(trainer_errors_rank, 2, cfgs, timeout=120)
    assert errors[0] == errors[1]
    batch, world, int8, lars = errors[0]
    assert lars.startswith("ValueError: lars needs per-layer norms, which the ZeRO-1 flat "
                           "layout destroys")
    assert batch.startswith("ValueError: with sp>1, batch_size 15 must also divide over the 2 "
                            "data x seq devices")
    assert world == "ValueError: 2 devices not divisible by sp/tp/ep/pp=4"
    # the JAX trainer's own wall (tpu_dist/train/trainer.py:443-455), ahead of
    # the step's since the trainer checks tp/ep/sp together
    assert int8.startswith("ValueError: grad_compression='int8' is scoped to the plain "
                           "data-parallel, fused-epoch, and ZeRO-1 paths")
