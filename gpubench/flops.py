"""Frozen work formulas and the card's peaks.

The operations a step needs are worked out from the cell's shapes, never
counted from what the program dispatches: a later change to how a step is
computed leaves them as they are. An operation is a multiply or an add (a
multiply-accumulate is 2). Only the products of matrices and convolutions
count, as model FLOPs are counted by convention; normalisation, softmax and
elementwise work do not. A training step is the forward, plus twice the
forward for the backward (the gradients of the activations and of the
weights), less the gradient of the input images, which no step computes.
Nothing recomputed counts.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES = 3.35e12


def vit_forward_flops(cfg: dict, image_size: int) -> int:
    """One image's forward through a ViT of ``cfg`` at ``image_size`` px:
    the patch embedding, per block the qkv, score, value, proj and two MLP
    products, and the head on the pooled token."""
    p, d, c = cfg["patch_size"], cfg["hidden_size"], cfg["num_channels"]
    s = (image_size // p) ** 2
    patch = 2 * s * (p * p * c) * d
    block = (2 * s * d * 3 * d            # qkv
             + 2 * s * s * d + 2 * s * s * d  # q k^T and p v over all heads
             + 2 * s * d * d               # proj
             + 2 * 2 * s * d * cfg["intermediate_size"])  # mlp1, mlp2
    head = 2 * d * cfg["num_classes"]
    return patch + cfg["num_hidden_layers"] * block + head


def vit_train_flops(cfg: dict, image_size: int, batch: int) -> int:
    """A training step of ``batch`` images: 3 forwards, less the patch
    embedding's input gradient."""
    p, d, c = cfg["patch_size"], cfg["hidden_size"], cfg["num_channels"]
    patch = 2 * (image_size // p) ** 2 * (p * p * c) * d
    return batch * (3 * vit_forward_flops(cfg, image_size) - patch)


def _resnet_convs(cfg: dict) -> list:
    """``[(out_hw, in_ch, out_ch, k)]`` of every convolution of a CIFAR
    ResNet with BasicBlocks (3x3 stem at stride 1, no max pool)."""
    hw = cfg["image_size"]
    widths, blocks = cfg["widths"], cfg["stage_blocks"]
    convs = [(hw, cfg["num_channels"], widths[0], 3)]
    in_ch = widths[0]
    for si, (w, n) in enumerate(zip(widths, blocks)):
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            hw //= stride
            convs.append((hw, in_ch, w, 3))
            convs.append((hw, w, w, 3))
            if stride != 1 or in_ch != w:
                convs.append((hw, in_ch, w, 1))  # the 1x1 shortcut
            in_ch = w
    return convs


def resnet_forward_flops(cfg: dict) -> int:
    """One image's forward through the CIFAR ResNet of ``cfg``."""
    convs = sum(2 * hw * hw * o * i * k * k for hw, i, o, k in _resnet_convs(cfg))
    return convs + 2 * cfg["widths"][-1] * cfg["num_classes"]


def resnet_train_flops(cfg: dict, batch: int) -> int:
    """A training step of ``batch`` images: 3 forwards, less the stem's
    input gradient."""
    hw, i, o, k = _resnet_convs(cfg)[0]
    return batch * (3 * resnet_forward_flops(cfg) - 2 * hw * hw * o * i * k * k)


def train_flops(cfg: dict, traffic: dict) -> int:
    """Model FLOPs of one training step of the cell (``cfg``'s family at
    the traffic's batch and resolution)."""
    if cfg["family"] == "vit":
        return vit_train_flops(cfg, traffic["image_size"], traffic["batch"])
    if cfg["family"] == "resnet_cifar":
        return resnet_train_flops(cfg, traffic["batch"])
    raise ValueError(f"no work formula for the family {cfg['family']!r}")


def attention_work(bh: int, s: int, d: int, itemsize: int) -> tuple:
    """``(operations, bytes)`` of one attention's forward and backward over
    ``bh`` heads of ``s`` tokens of width ``d``: 4·s²·d forward (q k^T, p
    v) and 8·s²·d backward (dv, dp, dq, dk) a head; q, k, v and the output
    gradient read once, the output, dq, dk and dv written once."""
    return 12 * bh * s * s * d, 8 * bh * s * d * itemsize


def sgd_bytes(n_params: int) -> int:
    """SGD with momentum over ``n_params`` f32 leaves: the parameter, its
    gradient and its momentum read, the parameter and momentum written."""
    return 5 * 4 * n_params


def roofline_pct(ops: int, nbytes: int, seconds: float) -> float:
    """The least time the card could take (the larger of the operations
    at the bf16 peak and the bytes at the HBM peak) over ``seconds``, in
    percent."""
    return 100.0 * max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) / seconds
