"""ResNet-18 on CIFAR-100 (``configs/resnet18_cifar100.json``) through the
port: ``tpu_dist_torch.nn.resnet.ResNet`` with BasicBlocks at the
configuration's widths and depths. Its plain reference is
:mod:`gpubench.reference.resnet`.

The weights are drawn on the device from the seed: convolutions normal at
sqrt(2 / fan-in) (He), the head normal over the square root of its
fan-in, BatchNorm scales 1 and every bias 0."""

from __future__ import annotations

from gpubench.reference import resnet as REFERENCE  # noqa: N812 — the harness reads it by this name


def weight_specs(cfg: dict, traffic: dict) -> list:
    """``[(name, shape, (kind, value))]`` in the port's parameter order."""
    del traffic

    def conv(name, out, inp, k):
        return [(f"{name}.weight", (out, inp, k, k), ("normal", (2.0 / (inp * k * k)) ** 0.5))]

    def bn(name, ch):
        return [(f"{name}.weight", (ch,), ("const", 1.0)), (f"{name}.bias", (ch,), ("const", 0.0))]

    widths = cfg["widths"]
    specs = conv("stem_conv", widths[0], cfg["num_channels"], 3) + bn("stem_bn", widths[0])
    in_ch = widths[0]
    for si, (w, n) in enumerate(zip(widths, cfg["stage_blocks"])):
        for bi in range(n):
            b = f"stage{si + 1}.{bi}"
            specs += conv(f"{b}.conv1", w, in_ch, 3) + bn(f"{b}.bn1", w)
            specs += conv(f"{b}.conv2", w, w, 3) + bn(f"{b}.bn2", w)
            if (si > 0 and bi == 0) or in_ch != w:
                specs += conv(f"{b}.sc_conv", w, in_ch, 1) + bn(f"{b}.sc_bn", w)
            in_ch = w
    return specs + [("fc.weight", (cfg["num_classes"], in_ch), ("normal", in_ch ** -0.5)),
                    ("fc.bias", (cfg["num_classes"],), ("const", 0.0))]


def port_model(cfg: dict, traffic: dict, device):
    """The port's CIFAR ResNet of this configuration."""
    del traffic
    from tpu_dist_torch.nn.resnet import ResNet  # noqa: PLC0415

    if cfg["block"] != "basic":
        raise ValueError(f"{cfg['name']}: the reference has BasicBlocks only")
    return ResNet("basic", tuple(cfg["stage_blocks"]), cfg["num_classes"],
                  widths=tuple(cfg["widths"]), device=device)
