"""The attention layer's share of its roofline: the port's attention entry
(``tpu_dist_torch.nn.attention.full_attention`` with the configuration's
``attn_impl``), forward and backward, on q, k and v cut from one qkv tensor
laid as the ViT block lays it, at the cell's batch, tokens and heads in the
compute dtype, timed alone with CUDA events behind a head start. The least
time is the larger of the work's operations at the bf16 peak and its bytes
at the HBM peak (``gpubench.flops.attention_work``)."""

import torch

from gpubench import flops, timing, traffic as gen


def read(run):
    cfg = run.cfg
    if "num_attention_heads" not in cfg or run.device.type != "cuda":
        return None
    from tpu_dist_torch.nn.attention import full_attention  # noqa: PLC0415

    b, heads = run.traffic["batch"], cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // heads
    s = (run.traffic["image_size"] // cfg["patch_size"]) ** 2
    dtype = getattr(torch, cfg["compute_dtype"])
    g = gen.generator(0, "attention", run.device)
    qkv = torch.randn(b, s, heads, 3, hd, generator=g, device=run.device).to(dtype)
    qkv.requires_grad_(True)
    do = torch.randn(b, s, heads, hd, generator=g, device=run.device).to(dtype)

    def fwd_bwd():
        out = full_attention(qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2],
                             impl=cfg["attn_impl"])
        torch.autograd.grad(out, qkv, do)

    ops, nbytes = flops.attention_work(b * heads, s, hd, qkv.element_size())
    return flops.roofline_pct(ops, nbytes, timing.device_seconds(fwd_bwd))
