"""The frozen work formulas against hand counts and against torch's
``FlopCounterMode`` over the plain reference's forward and backward."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import flops, traffic as gen
from gpubench.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
VIT = json.loads((ROOT / "gpubench/configs/vit_b16.json").read_text())
RESNET = json.loads((ROOT / "gpubench/configs/resnet18_cifar100.json").read_text())


@pytest.mark.parametrize("image_size, batch, hand", [(1024, 8, 3.166e13), (224, 256, 2.683e13)])
def test_vit_steps_against_the_hand_counts(image_size, batch, hand):
    # the hand counts are 3 forwards; a step never computes the patch
    # embedding's input gradient, 0.12% (1,024 px) and 0.22% (224 px) of it
    step = flops.vit_train_flops(VIT, image_size, batch)
    three = 3 * batch * flops.vit_forward_flops(VIT, image_size)
    assert three == pytest.approx(hand, rel=5e-4)  # the hand counts' four digits
    patch = 2 * (image_size // 16) ** 2 * 768 * 768 * batch
    assert step == three - patch
    assert step == pytest.approx(hand, rel=2.5e-3)


def _counted(model_name, cfg, traffic, batch):
    """FlopCounterMode over the reference's forward and the gradients of
    its weights (not of its input) at ``batch`` images."""
    man = Manifest(ROOT)
    model = man.model(model_name)
    w = gen.weights(model.weight_specs(cfg, traffic), 0, "cpu")
    for t in w.values():
        t.requires_grad_(True)
    hw = traffic["image_size"]
    x = torch.randn(batch, hw, hw, 3)
    with FlopCounterMode(display=False) as fc:
        loss = model.REFERENCE.forward(w, x, cfg).logsumexp(-1).sum()
        torch.autograd.grad(loss, list(w.values()))
    return fc.get_total_flops()


def test_resnet18_step_against_flop_counter_and_the_cost_model():
    step = flops.resnet_train_flops(RESNET, 256)
    counted = _counted("resnet18_cifar100", RESNET, {"image_size": 32}, 2)
    assert step == counted * 128  # every product of the step, at batch 256
    # the port's cost model (obs/costmodel.py) books 7.39e11: it counts a padded convolution's
    # valid taps only (the taps that land on padding cost nothing on XLA),
    # which at 4x4 to 32x32 positions is 13.3% less than the dense product
    # that model FLOPs count
    assert step == 852294107136
    assert step / 7.39338e11 == pytest.approx(1.1528, abs=1e-3)


def test_vit_formula_against_flop_counter_at_a_small_size():
    cfg = dict(VIT, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=256, num_classes=10, patch_size=8)
    counted = _counted("vit_b16", cfg, {"image_size": 32}, 2)
    # the counter sees the attention's products as bmm (the blocked
    # reference's forward once, its backward with the scores worked out
    # again): take them out and put the formula's 12·s²·d a head back
    s, d, heads, layers = 16, 64, 4, 2
    hd = d // heads
    recomputed = layers * 2 * heads * (2 * s * s * hd)  # q k^T again in the backward
    assert flops.vit_train_flops(cfg, 32, 2) == counted - recomputed


def test_attention_and_sgd_work():
    ops, nbytes = flops.attention_work(96, 4096, 64, 2)
    assert ops == 12 * 96 * 4096 ** 2 * 64  # 1.237e12
    assert ops / flops.PEAK_BF16_FLOPS * 1e3 == pytest.approx(1.2506, rel=1e-3)
    assert nbytes == 8 * 96 * 4096 * 64 * 2
    _, small = flops.attention_work(3072, 196, 64, 2)
    assert small / flops.PEAK_HBM_BYTES > 9.06e10 / flops.PEAK_BF16_FLOPS  # bytes-bound at 224
    assert flops.sgd_bytes(11220132) == 224402640
    assert flops.roofline_pct(0, flops.sgd_bytes(11220132), 0.0816e-3) == pytest.approx(82.09,
                                                                                         abs=0.05)
