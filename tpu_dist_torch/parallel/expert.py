"""Expert parallelism: the top-k Mixture-of-Experts of
``tpu_dist/parallel/expert.py``, with capacity-based dispatch and combine,
over an expert group.

* Every rank holds ``E/n`` experts' weights (the expert slabs ``w_in``
  ``[E/n, d, f]`` and ``w_out`` ``[E/n, f, d]``, JAX's layout); the router
  is replicated. The router is an ``nn.Linear`` weight ``[E, d]`` here
  (JAX's ``[d, E]`` transposed, as every dense kernel crosses the bridge).
* Tokens are routed top-k (k = 1 Switch, k = 2 GShard) with a capacity
  ``C`` a expert; every token's first choice claims a slot before any
  token's second choice (choice-major priority).
* Dispatch: a one-hot einsum packs tokens into ``[E, C, d]`` slots, ONE
  exchange over the group (:func:`~tpu_dist_torch.comm.collectives.
  all_to_all_tiled` along dim 0 of ``[n, e_loc, C, d]``) moves each
  expert's slots to its owner, the owner runs its experts, and the
  reverse exchange plus the gate-weighted combine restore token order.
  The exchange's backward is the reverse exchange, so autograd gives each
  rank's expert slabs the sum over the group of every rank's loss
  gradient (the step divides it by ``n``).

Tokens over an expert's capacity are dropped: that choice contributes 0
and the block's residual carries the token.

Ties in the router's top-k go to the lower expert index, as
``lax.top_k``'s do: :func:`top_k` is a stable descending sort, not
``torch.topk``, whose order among equal values is not documented.

The einsums run in PyTorch (``torch.einsum``): the JAX package computes
them outside any Pallas kernel too.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpu_dist_torch.comm import collectives


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """``(values, indices)`` of the ``k`` largest entries of each row,
    largest first, ties to the lower index (``lax.top_k``'s order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


@dataclasses.dataclass(frozen=True)
class MoE:
    """Top-k MoE FFN. ``n_experts`` must be a multiple of the expert group's
    size. ``params`` is ``{"router": [E, d], "w_in": [E, d, f], "w_out":
    [E, f, d]}`` (the expert slabs of this rank under EP); each weight is
    cast to the activation dtype where it is used, as the JAX step casts
    the parameter tree. ``top_k = 1`` gates by the raw softmax probability
    (Switch), ``top_k > 1`` renormalises the chosen probabilities to sum to
    one (GShard)."""

    n_experts: int
    capacity_factor: float = 1.25
    top_k: int = 1

    def apply_dense(self, params, x, *, with_aux: bool = False):
        """[T, d] -> [T, d] on one rank with every expert: the ground truth
        of :meth:`apply_ep`. ``with_aux`` also returns the load-balancing
        loss."""
        C = self._capacity(x.shape[0])
        pack, combine, aux = self._route(params["router"], x, C)
        slots = torch.einsum("tec,td->ecd", pack, x)
        h = _gelu(torch.einsum("ecd,edf->ecf", slots, params["w_in"].to(x.dtype)))
        out = torch.einsum("ecf,efd->ecd", h, params["w_out"].to(x.dtype))
        y = torch.einsum("tec,ecd->td", combine, out)
        return (y, aux) if with_aux else y

    def apply_ep(self, router, w_in_local, w_out_local, x, ep, *, with_aux: bool = False):
        """The expert-parallel forward of this rank's tokens ``x`` [T_loc, d]
        over the expert group ``ep`` (an
        :class:`~tpu_dist_torch.comm.mesh.AxisGroup`): route and pack, one
        exchange of the ``[n, e_loc, C, d]`` slot blocks, the local experts,
        the reverse exchange, the combine."""
        n = ep.size
        d = x.shape[1]
        e_loc = self.n_experts // n
        C = self._capacity(x.shape[0])
        pack, combine, aux = self._route(router, x, C)
        slots = torch.einsum("tec,td->ecd", pack, x).reshape(n, e_loc, C, d)
        recv = collectives.all_to_all_tiled(slots, 0, 0, group=ep.group, kind="moe")
        out = self._experts(recv, w_in_local, w_out_local)
        back = collectives.all_to_all_tiled(out, 0, 0, group=ep.group, kind="moe")
        y = torch.einsum("tec,ecd->td", combine, back.reshape(self.n_experts, C, d))
        return (y, aux) if with_aux else y

    def apply_ep_lockstep(self, router, w_in, w_out, xs: list, *, with_aux: bool = False):
        """:meth:`apply_ep` of an expert group whose ``n = len(xs)`` ranks are
        virtual ranks of one process: rank ``r`` routes ``xs[r]`` and owns
        the experts ``[r·E/n, (r+1)·E/n)`` of the full ``w_in``/``w_out``.
        The exchange is the permutation of slot blocks that the all-to-all
        makes (rank ``j`` receives block ``j`` of every rank). Returns the
        ranks' outputs (and their auxiliary losses)."""
        n = len(xs)
        d = xs[0].shape[1]
        e_loc = self.n_experts // n
        routed = []
        for x in xs:
            C = self._capacity(x.shape[0])
            pack, combine, aux = self._route(router, x, C)
            slots = torch.einsum("tec,td->ecd", pack, x).reshape(n, e_loc, C, d)
            routed.append((slots, combine, aux, C))
        outs = []
        for j in range(n):
            recv = torch.stack([slots[j] for slots, *_ in routed])
            lo, hi = j * e_loc, (j + 1) * e_loc
            outs.append(self._experts(recv, w_in[lo:hi], w_out[lo:hi]))
        ys, auxes = [], []
        for i, (_, combine, aux, C) in enumerate(routed):
            back = torch.stack([outs[j][i] for j in range(n)])
            ys.append(torch.einsum("tec,ecd->td", combine, back.reshape(self.n_experts, C, d)))
            auxes.append(aux)
        return (ys, auxes) if with_aux else ys

    @staticmethod
    def _experts(recv, w_in_local, w_out_local):
        """The local experts on the received ``[n, e_loc, C, d]`` slots."""
        h = _gelu(torch.einsum("necd,edf->necf", recv, w_in_local.to(recv.dtype)))
        return torch.einsum("necf,efd->necd", h, w_out_local.to(recv.dtype))

    def _capacity(self, T: int) -> int:
        # Python float arithmetic, as the JAX function's: C = int(cf·k·T/E)
        return max(1, int(self.capacity_factor * self.top_k * T / self.n_experts))

    def _route(self, router, x, C: int):
        """Top-k routing with capacity: the ``[T, E, C]`` dispatch tensors
        ``pack`` (binary: the slot each token holds, up to k of them) and
        ``combine`` (gate-weighted), and the load-balancing loss ``E · Σ_e
        f_e · P_e`` (``f_e`` the share of tokens whose first choice is
        ``e``, not differentiable; ``P_e`` the mean router probability of
        ``e``)."""
        T = x.shape[0]
        E, k = self.n_experts, self.top_k
        logits = x.float() @ router.to(x.dtype).float().t()
        probs = torch.softmax(logits, dim=-1)
        topk_probs, topk_idx = top_k(probs, k)
        if k == 1:
            gates = topk_probs  # Switch: the raw probability
        else:  # GShard: renormalised
            gates = topk_probs / torch.clamp(topk_probs.sum(-1, keepdim=True), min=1e-9)
        # choice-major slot assignment: every token's first choice outranks
        # any token's second choice for the capacity
        oh = F.one_hot(topk_idx, E).to(torch.int32)                  # [T, k, E]
        oh_cm = oh.permute(1, 0, 2).reshape(k * T, E)                 # [k*T, E]
        pos = torch.cumsum(oh_cm, dim=0) * oh_cm - 1                  # slot per entry
        keep = (pos < C) & (pos >= 0)
        slot = torch.where(keep, pos, torch.full_like(pos, -1)).amax(-1)  # -1: dropped
        pos_oh = (slot[:, None] == torch.arange(C, device=x.device)).to(x.dtype)
        disp_k = (oh_cm.to(x.dtype)[:, :, None] * pos_oh[:, None, :]).reshape(k, T, E, C)
        pack = disp_k.sum(0)
        combine = torch.einsum("ktec,tk->tec", disp_k, gates.to(x.dtype))
        f_e = oh[:, 0, :].float().mean(0)
        P_e = probs.mean(0)
        aux = E * torch.sum(f_e * P_e)
        return pack, combine, aux.to(x.dtype)
