"""ViT with Mixture-of-Experts FFN blocks: the port's counterpart of
``tpu_dist/nn/vit_moe.py`` (``ViTMoEDef``, ``vit_moe_tiny``).

Every block's dense MLP is the top-k MoE of
:class:`tpu_dist_torch.parallel.expert.MoE`. With an expert group (``ep=``,
an :class:`~tpu_dist_torch.comm.mesh.AxisGroup`) the module holds this
rank's expert slabs (``w_in`` ``[E/n, d, f]``, ``w_out`` ``[E/n, f, d]``,
:meth:`ViTMoE.ep_param_specs`) and each block exchanges its tokens with
their experts' owners, one exchange a direction; the batch is sharded over
the data and the expert axes alike (the expert axis carries data outside
the MoE). No conjugate pair is needed: a block's input is this rank's
data, and the exchange's backward is the reverse exchange. The whole
correction is the step's reduce (``train/step.py``): expert-sharded
leaves the mean over the data axis divided by ``n``, replicated leaves the
mean over every rank.

In training the forward returns ``(logits, moe_aux_loss)``, the router
load-balancing loss averaged over the blocks (the JAX ``apply``'s
``{"moe_aux_loss": ...}`` state); the step adds ``moe_aux_coef`` times it
to the objective. In eval mode it returns the logits. Layout and numerics
are :mod:`tpu_dist_torch.nn.vit`'s; weights are drawn from ``seed`` at full
width on every rank and the expert slabs cut, so an EP rank holds the
one-device model's slabs.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_dist_torch import resolve_device
from tpu_dist_torch.comm import mesh
from tpu_dist_torch.nn import attention as attn_lib
from tpu_dist_torch.nn.vit import _dense, _ln, check_pos_capacity, patchify, shard_params_
from tpu_dist_torch.parallel.expert import MoE

#: the expert slabs, sharded on their leading (expert) dimension
EP_BLOCK_SPECS = {"moe.w_in": 0, "moe.w_out": 0}


class Experts(nn.Module):
    """One block's MoE parameters: the router (``[E, d]``, no bias) and the
    expert slabs in JAX's layout."""

    def __init__(self, dim: int, hidden: int, n_experts: int):
        super().__init__()
        self.router = nn.Linear(dim, n_experts, bias=False)
        self.w_in = nn.Parameter(torch.empty(n_experts, dim, hidden))
        self.w_out = nn.Parameter(torch.empty(n_experts, hidden, dim))

    def params(self) -> dict:
        return {"router": self.router.weight, "w_in": self.w_in, "w_out": self.w_out}


class MoEBlock(nn.Module):
    """One block's parameters: the attention's, then the MoE's in place of
    the dense MLP (the forward is :meth:`ViTMoE.forward`'s loop)."""

    def __init__(self, dim: int, n_experts: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.moe = Experts(dim, 4 * dim, n_experts)


class ViTMoE(nn.Module):
    """The ``ViTMoEDef`` fields as a module (``n_experts``,
    ``capacity_factor`` and ``top_k`` make its :class:`MoE`)."""

    def __init__(self, image_size: int = 32, patch_size: int = 4, dim: int = 64,
                 depth: int = 2, heads: int = 4, n_experts: int = 8,
                 capacity_factor: float = 2.0, top_k: int = 1, num_classes: int = 10, *,
                 attn_impl: str = "xla", device="cuda", seed: int = 0, ep=None):
        super().__init__()
        if attn_impl not in attn_lib.IMPLS:
            raise ValueError(f"attn_impl must be 'xla' or 'flash', got {attn_impl!r}")
        dev = resolve_device(device)
        self.image_size = image_size
        self.patch_size = patch_size
        self.dim = dim
        self.depth = depth
        self.heads = heads
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.top_k = top_k
        self.num_classes = num_classes
        self.attn_impl = attn_impl
        self.patch = nn.Linear(patch_size * patch_size * 3, dim)
        self.pos = nn.Parameter(torch.empty(self.n_patches, dim))
        self.blocks = nn.ModuleList(MoEBlock(dim, n_experts) for _ in range(depth))
        self.ln_f = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, num_classes)
        self._init_weights(torch.Generator().manual_seed(seed))
        self.ep = ep
        if ep is not None:
            if n_experts % ep.size:
                raise ValueError(f"{n_experts} experts not divisible by ep={ep.size}")
            shard_params_(self, ep)
        self.to(dev)

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def moe(self) -> MoE:
        return MoE(self.n_experts, self.capacity_factor, self.top_k)

    @property
    def shard_axis(self):
        """The expert group the slabs are sharded over (None: all here)."""
        return self.ep

    def ep_param_specs(self) -> dict:
        """``{parameter name: (axis, torch dim)}`` of the expert slabs
        (``ViTMoEDef.ep_param_specs``; everything else is replicated)."""
        return {f"blocks.{i}.{leaf}": (mesh.EXPERT_AXIS, dim)
                for i in range(self.depth) for leaf, dim in EP_BLOCK_SPECS.items()}

    def param_specs(self) -> dict:
        return self.ep_param_specs() if self.ep is not None else {}

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """``ViTMoEDef.init``'s distributions: normal / sqrt(fan_in) kernels
        (the router and ``w_in`` by ``d``, ``w_out`` by ``f``), zero
        biases, unit LayerNorm scales, normal * 0.02 positions."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                                 * mod.weight.shape[1] ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, Experts):
                mod.w_in.copy_(torch.randn(mod.w_in.shape, generator=gen) * self.dim ** -0.5)
                mod.w_out.copy_(torch.randn(mod.w_out.shape, generator=gen)
                                * mod.w_out.shape[1] ** -0.5)
        self.pos.copy_(torch.randn(self.pos.shape, generator=gen) * 0.02)

    def forward(self, x):
        """Logits of images ``x`` [B, H, W, 3]; in training also the
        depth-averaged load-balancing loss (module docstring)."""
        t = _dense(self.patch, patchify(x, self.patch_size))
        check_pos_capacity(t.shape[1], self.pos, self.image_size, self.patch_size)
        t = t + self.pos[: t.shape[1]].to(t.dtype)[None]
        moe = self.moe
        b, h_dim = t.shape[0], self.dim // self.heads
        aux_total = torch.zeros((), dtype=torch.float32, device=t.device)
        for blk in self.blocks:
            qkv = _dense(blk.qkv, _ln(blk.ln1, t))
            s = qkv.shape[1]
            qkv = qkv.reshape(b, s, self.heads, 3, h_dim)
            q, k, v = (qkv[:, :, :, i, :] for i in range(3))
            o = attn_lib.full_attention(q, k, v, impl=self.attn_impl)
            t = t + _dense(blk.proj, o.reshape(b, s, self.dim))
            flat = _ln(blk.ln2, t).reshape(b * s, self.dim)
            p = blk.moe.params()
            if self.ep is None:
                out, aux = moe.apply_dense(p, flat, with_aux=True)
            else:
                out, aux = moe.apply_ep(p["router"], p["w_in"], p["w_out"], flat, self.ep,
                                        with_aux=True)
            aux_total = aux_total + aux.float()
            t = t + out.reshape(b, s, self.dim)
        logits = _dense(self.head, _ln(self.ln_f, t).mean(dim=1))
        if self.training:
            return logits, aux_total / self.depth
        return logits


def vit_moe_tiny(num_classes: int = 10, image_size: int = 32, **kw) -> ViTMoE:
    """``vit_moe_tiny``: 8 experts, capacity factor 2, over vit_tiny's
    widths."""
    return ViTMoE(image_size=image_size, num_classes=num_classes, **kw)
