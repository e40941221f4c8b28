"""ViT (arXiv:2010.11929) as the configurations run it: patches cut in
``(row, column, channel)`` order and embedded by a linear map, a learned
position row per token, pre-norm blocks (LayerNorm, multi-head attention
with the qkv output laid ``[heads, 3, head dim]``, LayerNorm, a tanh-GELU
MLP), a final LayerNorm, the mean over the tokens (no class token, as in
arXiv:2205.01580) and a linear head."""

from __future__ import annotations

from gpubench.reference import layers as L
from gpubench.reference.attention import attention


def patchify(x, p: int):
    """``[B, H, W, C]`` -> ``[B, (H/p)(W/p), p·p·C]``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def forward(w: dict, images, cfg: dict, precision: str = "f32"):
    """Logits of ``images`` ``[B, H, W, C]`` under the weights ``w``."""
    d, heads, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg["layer_norm_eps"]
    hd = d // heads
    t = L.linear(patchify(images, cfg["patch_size"]), w["patch.weight"], w["patch.bias"], precision)
    b, s, _ = t.shape
    t = L.rounded(t + w["pos"][:s][None], precision)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"blocks.{i}."
        y = L.layer_norm(t, w[pre + "ln1.weight"], w[pre + "ln1.bias"], eps, precision)
        qkv = L.linear(y, w[pre + "qkv.weight"], w[pre + "qkv.bias"], precision)
        qkv = qkv.reshape(b, s, heads, 3, hd).permute(3, 0, 2, 1, 4).reshape(3, b * heads, s, hd)
        q, k, v = (L.rounded(qkv[j], precision) for j in range(3))
        o = L.rounded(attention(q, k, v), precision)
        o = o.reshape(b, heads, s, hd).permute(0, 2, 1, 3).reshape(b, s, d)
        t = L.rounded(t + L.linear(o, w[pre + "proj.weight"], w[pre + "proj.bias"], precision),
                      precision)
        y = L.layer_norm(t, w[pre + "ln2.weight"], w[pre + "ln2.bias"], eps, precision)
        h = L.linear(y, w[pre + "mlp1.weight"], w[pre + "mlp1.bias"], precision)
        h = L.rounded(L.gelu_tanh(h), precision)
        t = L.rounded(t + L.linear(h, w[pre + "mlp2.weight"], w[pre + "mlp2.bias"], precision),
                      precision)
    pooled = L.rounded(L.layer_norm(t, w["ln_f.weight"], w["ln_f.bias"], eps, precision)
                       .mean(dim=1), precision)
    return L.linear(pooled, w["head.weight"], w["head.bias"], precision)


#: A batch's loss is the sum of its rows' losses (each token is normalised
#: alone), so the reference may run a batch a block of rows at a time.
ROWS_INDEPENDENT = True
