"""ViT-B/16 (``configs/vit_b16.json``) through the port:
``tpu_dist_torch.nn.vit.ViT`` at the configuration's widths, one learned
position row per patch token of the traffic's resolution, the flash
attention kernels. Its plain reference is :mod:`gpubench.reference.vit`.

The weights follow the port's own distributions (normal over the square
root of the fan-in for every linear map, zero biases, unit LayerNorm
scales, positions normal at 0.02), drawn on the device from the seed."""

from __future__ import annotations

from gpubench.reference import vit as REFERENCE  # noqa: N812 — the harness reads it by this name


def weight_specs(cfg: dict, traffic: dict) -> list:
    """``[(name, shape, (kind, value))]`` in the port's parameter order."""
    d, p, c = cfg["hidden_size"], cfg["patch_size"], cfg["num_channels"]
    f, k = cfg["intermediate_size"], cfg["num_classes"]
    s = (traffic["image_size"] // p) ** 2

    def dense(name, out, fan_in):
        return [(f"{name}.weight", (out, fan_in), ("normal", fan_in ** -0.5)),
                (f"{name}.bias", (out,), ("const", 0.0))]

    def norm(name):
        return [(f"{name}.weight", (d,), ("const", 1.0)), (f"{name}.bias", (d,), ("const", 0.0))]

    specs = dense("patch", d, p * p * c) + [("pos", (s, d), ("normal", 0.02))]
    for i in range(cfg["num_hidden_layers"]):
        b = f"blocks.{i}"
        specs += (norm(f"{b}.ln1") + dense(f"{b}.qkv", 3 * d, d) + dense(f"{b}.proj", d, d)
                  + norm(f"{b}.ln2") + dense(f"{b}.mlp1", f, d) + dense(f"{b}.mlp2", d, f))
    return specs + norm("ln_f") + dense("head", k, d)


def port_model(cfg: dict, traffic: dict, device):
    """The port's ViT for this configuration at the traffic's resolution."""
    from tpu_dist_torch.nn.vit import ViT  # noqa: PLC0415

    return ViT(image_size=traffic["image_size"], patch_size=cfg["patch_size"],
               dim=cfg["hidden_size"], depth=cfg["num_hidden_layers"],
               heads=cfg["num_attention_heads"],
               mlp_ratio=cfg["intermediate_size"] // cfg["hidden_size"],
               num_classes=cfg["num_classes"], pool=cfg["pool"], attn_impl=cfg["attn_impl"],
               device=device)
