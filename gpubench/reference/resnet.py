"""The CIFAR ResNet (arXiv:1512.03385 in the reference repository's
CIFAR form): a 3x3 stem at stride 1 without max pool, stages of
BasicBlocks at strides 1, 2, 2, 2, a 1x1 convolution and BatchNorm on the
shortcut where the shape changes, bias-free convolutions each followed by
the JAX package's BatchNorm formula in training mode, the mean over the
positions and a linear head."""

from __future__ import annotations

import torch

from gpubench.reference import layers as L


def _bn(w: dict, name: str, x, eps: float, precision: str):
    return L.batch_norm_train(x, w[name + ".weight"], w[name + ".bias"], eps, precision)


def forward(w: dict, images, cfg: dict, precision: str = "f32"):
    """Logits of NHWC ``images`` under the weights ``w`` (training-mode
    BatchNorm: each layer normalises by the batch's statistics)."""
    eps = cfg["bn_eps"]
    y = images.permute(0, 3, 1, 2)
    y = torch.relu(_bn(w, "stem_bn", L.conv2d(y, w["stem_conv.weight"], 1, 1, precision), eps,
                       precision))
    in_ch = cfg["widths"][0]
    for si, (width, n) in enumerate(zip(cfg["widths"], cfg["stage_blocks"])):
        for bi in range(n):
            pre = f"stage{si + 1}.{bi}."
            stride = 2 if si > 0 and bi == 0 else 1
            h = L.conv2d(y, w[pre + "conv1.weight"], stride, 1, precision)
            h = torch.relu(_bn(w, pre + "bn1", h, eps, precision))
            h = _bn(w, pre + "bn2", L.conv2d(h, w[pre + "conv2.weight"], 1, 1, precision), eps,
                    precision)
            if stride != 1 or in_ch != width:
                sc = L.conv2d(y, w[pre + "sc_conv.weight"], stride, 0, precision)
                sc = _bn(w, pre + "sc_bn", sc, eps, precision)
            else:
                sc = y
            y = L.rounded(torch.relu(h + sc), precision)
            in_ch = width
    pooled = L.rounded(y.mean(dim=(2, 3)), precision)
    return L.linear(pooled, w["fc.weight"], w["fc.bias"], precision)


#: BatchNorm normalises by the whole batch's statistics: a batch runs whole.
ROWS_INDEPENDENT = False
