"""CIFAR-style ResNet-18/34/50 and the ImageNet ResNet-50: the port's
counterpart of ``tpu_dist/nn/resnet.py`` (``ResNetDef``, ``resnet18``,
``resnet34``, ``resnet50``, ``resnet50_imagenet``).

The architecture is the JAX model's: a 3×3 stem without max pool (or the
7×7/2 stem and a 3×3/2 max pool for ImageNet), stages of ``widths`` with
strides 1, 2, 2, 2, BasicBlock (expansion 1) for 18/34 and BottleNeck
(expansion 4) for 50, a 1×1 shortcut conv + BN where the shape changes,
global average pool and a linear head. Every conv is bias-free and
followed by BatchNorm (:class:`tpu_dist_torch.nn.layers.BatchNorm`).

Module names follow the JAX pytree keys (``stem_conv``, ``stem_bn``,
``stage1.0.conv1``, ``stage1.0.bn1``, ``sc_conv``, ``fc``, ...), which is
what :mod:`tpu_dist_torch.bridge` maps. The input is NHWC, as the loader
delivers it; ``x.permute(0, 3, 1, 2)`` is an NCHW view with channels-last
memory, kept as it is for the convolutions. ``forward(x, train=, group=)``
returns the logits; in training it updates every BN layer's running
statistics in place (the JAX ``new_state``), and ``group`` makes them
SyncBN over that process group.

The JAX model's ``s2d_stem`` (the ImageNet stem as a 4×4 conv over a
space-to-depth input, to fill the TPU MXU's input lanes) computes the
same function as the plain 7×7 stem and is not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_dist_torch import resolve_device
from tpu_dist_torch.nn import layers as L


class Block(nn.Module):
    """BasicBlock (``"basic"``) or BottleNeck (``"bottleneck"``)."""

    def __init__(self, kind: str, in_ch: int, width: int, stride: int, gen: torch.Generator):
        super().__init__()
        self.kind, self.stride = kind, stride
        self.out_ch = width * (1 if kind == "basic" else 4)
        if kind == "basic":
            self.conv1 = L.conv_module(in_ch, width, 3, gen)
            self.bn1 = L.BatchNorm(width)
            self.conv2 = L.conv_module(width, self.out_ch, 3, gen)
            self.bn2 = L.BatchNorm(self.out_ch)
        else:
            self.conv1 = L.conv_module(in_ch, width, 1, gen)
            self.bn1 = L.BatchNorm(width)
            self.conv2 = L.conv_module(width, width, 3, gen)
            self.bn2 = L.BatchNorm(width)
            self.conv3 = L.conv_module(width, self.out_ch, 1, gen)
            self.bn3 = L.BatchNorm(self.out_ch)
        self.has_shortcut = stride != 1 or in_ch != self.out_ch
        if self.has_shortcut:
            self.sc_conv = L.conv_module(in_ch, self.out_ch, 1, gen)
            self.sc_bn = L.BatchNorm(self.out_ch)

    def forward(self, x, *, train: bool, group=None):
        bn = dict(train=train, group=group)
        if self.kind == "basic":
            y = L.conv_apply(self.conv1.weight, x, stride=self.stride, padding=1)
            y = torch.relu(self.bn1(y, **bn))
            y = self.bn2(L.conv_apply(self.conv2.weight, y, padding=1), **bn)
        else:
            y = torch.relu(self.bn1(L.conv_apply(self.conv1.weight, x), **bn))
            y = L.conv_apply(self.conv2.weight, y, stride=self.stride, padding=1)
            y = torch.relu(self.bn2(y, **bn))
            y = self.bn3(L.conv_apply(self.conv3.weight, y), **bn)
        if self.has_shortcut:
            sc = self.sc_bn(L.conv_apply(self.sc_conv.weight, x, stride=self.stride), **bn)
        else:
            sc = x
        return torch.relu(y + sc)


class ResNet(nn.Module):
    """The ``ResNetDef`` fields as a module; weights drawn from ``seed``
    with an explicit :class:`torch.Generator` in torch's default
    distributions (a bridged state dict replaces them)."""

    def __init__(self, block: str, stage_blocks: Tuple[int, int, int, int],
                 num_classes: int = 100, widths: Tuple[int, int, int, int] = (64, 128, 256, 512),
                 imagenet_stem: bool = False, s2d_stem: bool = False, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck', got {block!r}")
        if s2d_stem:
            raise NotImplementedError(
                "s2d_stem is a TPU-only layout of the ImageNet stem (a space-to-depth "
                "4x4 conv that fills the MXU's input lanes) and is not ported; the "
                "plain 7x7 stem (s2d_stem=False) computes the same function"
            )
        dev = resolve_device(device)
        self.block, self.stage_blocks, self.num_classes = block, tuple(stage_blocks), num_classes
        self.widths, self.imagenet_stem = tuple(widths), imagenet_stem
        gen = torch.Generator().manual_seed(seed)
        self.stem_conv = L.conv_module(3, widths[0], 7 if imagenet_stem else 3, gen)
        self.stem_bn = L.BatchNorm(widths[0])
        in_ch = widths[0]
        for si, (width, n_blocks, stride) in enumerate(zip(widths, stage_blocks, (1, 2, 2, 2))):
            blocks = nn.ModuleList()
            for bi in range(n_blocks):
                blocks.append(Block(block, in_ch, width, stride if bi == 0 else 1, gen))
                in_ch = blocks[-1].out_ch
            setattr(self, f"stage{si + 1}", blocks)
        self.fc = L.linear_module(in_ch, num_classes, gen)
        self.to(dev)

    def forward(self, x, *, train=None, group=None):
        """``x``: NHWC images. ``train`` defaults to ``self.training``."""
        train = self.training if train is None else train
        bn = dict(train=train, group=group)
        y = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        if self.imagenet_stem:
            y = L.conv_apply(self.stem_conv.weight, y, stride=2, padding=3)
        else:
            y = L.conv_apply(self.stem_conv.weight, y, stride=1, padding=1)
        y = torch.relu(self.stem_bn(y, **bn))
        if self.imagenet_stem:
            y = F.max_pool2d(y, 3, stride=2, padding=1)
        for si in range(4):
            for blk in getattr(self, f"stage{si + 1}"):
                y = blk(y, **bn)
        return L.linear_apply(self.fc.weight, self.fc.bias, L.global_avg_pool(y))


def resnet18(num_classes: int = 100, **kw) -> ResNet:
    """ResNet-18, CIFAR stem (11,220,132 parameters at 100 classes)."""
    return ResNet("basic", (2, 2, 2, 2), num_classes, **kw)


def resnet34(num_classes: int = 100, **kw) -> ResNet:
    return ResNet("basic", (3, 4, 6, 3), num_classes, **kw)


def resnet50(num_classes: int = 100, **kw) -> ResNet:
    return ResNet("bottleneck", (3, 4, 6, 3), num_classes, **kw)


def resnet50_imagenet(num_classes: int = 1000, s2d_stem: bool = False, **kw) -> ResNet:
    """Canonical ImageNet ResNet-50 (7x7 stem + max pool)."""
    return ResNet("bottleneck", (3, 4, 6, 3), num_classes, imagenet_stem=True,
                  s2d_stem=s2d_stem, **kw)
