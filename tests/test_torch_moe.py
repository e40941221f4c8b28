"""The port's top-k MoE (``tpu_dist_torch/parallel/expert.py``) held
against the JAX package's (``tpu_dist/parallel/expert.py``): the capacity
for every token count, the routing's slot assignment (bit for bit, with
capacity overflow and a router whose probabilities tie), its combine
weights and its load-balancing loss at k = 1 and 2; ``apply_ep`` on 4 gloo
ranks against JAX's ``apply_ep`` over a 4-device expert mesh and against
``apply_dense`` shard by shard, forward and gradients; the lockstep
exchange the card runs; and the ``vit_moe_tiny`` forward against
``ViTMoEDef.apply``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from model_parallel_jax import mesh_of
from torch_ranks import moe_ep_rank, run_ranks

from tpu_dist.comm.compat import shard_map
from tpu_dist.nn.vit_moe import vit_moe_tiny as jax_vit_moe_tiny
from tpu_dist.parallel.expert import MoE as JaxMoE
from tpu_dist_torch import bridge
from tpu_dist_torch.nn import vit_moe
from tpu_dist_torch.parallel.expert import MoE, top_k

# f32 on both sides: the softmax, the gates and the einsums in another
# order (XLA's fused dots vs PyTorch's), a few ulps of values of order 1
F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 0.3])
def test_capacity_is_the_jax_float_arithmetic(cf, k):
    """``int(cf·k·T/E)``, at least 1, for every T up to 300: one float
    operation order, so C never differs by one."""
    for E in (4, 8):
        ours, theirs = MoE(E, cf, k), JaxMoE(E, cf, k)
        assert [ours._capacity(T) for T in range(1, 301)] == \
            [theirs._capacity(T) for T in range(1, 301)]


def _router(kind, d, E, rng):
    if kind == "tied":
        # pairs of equal columns (and one column three times): equal
        # probabilities that the top-k must split toward the lower index
        base = rng.standard_normal((d, E // 2)).astype(np.float32)
        r = np.repeat(base, 2, axis=1)
        r[:, -1] = r[:, 0]
        return r
    if kind == "uniform":
        return np.zeros((d, E), np.float32)  # every probability 1/E
    return rng.standard_normal((d, E)).astype(np.float32)


ROUTES = [(k, kind, cf) for k in (1, 2) for kind in ("random", "tied", "uniform")
          for cf in (0.5, 2.0)]


@pytest.mark.parametrize("k,kind,cf", ROUTES, ids=[f"k{k}-{kind}-cf{cf}" for k, kind, cf in ROUTES])
def test_route_matches_jax_bit_for_bit_in_its_slots(k, kind, cf):
    """The dispatch tensor (which slot each token's choice holds, or none
    when its expert is full) equal to JAX's; the gate-weighted combine and
    the auxiliary loss to f32 rounding. ``cf`` 0.5 overflows the
    capacity."""
    rng = np.random.default_rng(7)
    T, d, E = 24, 8, 4
    x = rng.standard_normal((T, d)).astype(np.float32)
    router = _router(kind, d, E, rng)
    C = MoE(E, cf, k)._capacity(T)
    pack, combine, aux = MoE(E, cf, k)._route(torch.from_numpy(np.ascontiguousarray(router.T)),
                                              torch.from_numpy(x), C)
    jpack, jcombine, jaux = jax.jit(JaxMoE(E, cf, k)._route, static_argnums=2)(
        {"router": jnp.asarray(router)}, jnp.asarray(x), C)
    np.testing.assert_array_equal(pack.numpy(), np.asarray(jpack))
    np.testing.assert_allclose(combine.numpy(), np.asarray(jcombine), **F32_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **F32_TOL)
    if cf == 0.5:  # some choice was dropped for want of a slot
        assert pack.sum().item() < k * T


def test_top_k_ties_go_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1], [0.3, 0.2, 0.3, 0.2]])
    values, idx = top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 2], [0, 2]]
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(jidx).tolist()


# -- apply_ep over 4 gloo ranks ------------------------------------------------------

N, T, D, E, FF = 4, 32, 8, 8, 16
KS = (1, 2)


def _moe_inputs():
    rng = np.random.default_rng(11)
    params = {"router": rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5,
              "w_in": rng.standard_normal((E, D, FF)).astype(np.float32) * D ** -0.5,
              "w_out": rng.standard_normal((E, FF, D)).astype(np.float32) * FF ** -0.5}
    x = rng.standard_normal((T, D)).astype(np.float32)
    ct = rng.standard_normal((T, D)).astype(np.float32)
    return params, x, ct


def _jax_ep(k, params, x, ct):
    moe = JaxMoE(E, 1.25, k)

    def local(router, w_in, w_out, xl, ctl):
        def f(router, w_in, w_out, xl):
            y, aux = moe.apply_ep(router, w_in, w_out, xl, "expert", with_aux=True)
            return jnp.sum(y * ctl) + aux, (y, aux)
        (_, (y, aux)), g = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
            router, w_in, w_out, xl)
        return y, aux[None], g[3], g[0][None], g[1], g[2]

    fn = jax.jit(shard_map(local, mesh=mesh_of([N], ["expert"]),
                           in_specs=(P(), P("expert"), P("expert"), P("expert"), P("expert")),
                           out_specs=(P("expert"),) * 6, check_vma=False))
    return [np.asarray(a) for a in fn(params["router"], params["w_in"], params["w_out"], x, ct)]


@pytest.fixture(scope="module")
def ep_runs():
    params, x, ct = _moe_inputs()
    return (run_ranks(moe_ep_rank, N, KS, params, x, ct, timeout=60),
            {k: _jax_ep(k, params, x, ct) for k in KS}, params, x)


@pytest.mark.parametrize("i", range(len(KS)), ids=[f"k{k}" for k in KS])
def test_apply_ep_matches_jax_apply_ep_and_dense(ep_runs, i):
    """Each rank's output, auxiliary loss and gradients (its tokens, the
    router's on its tokens, its two expert slabs, which gather every rank's
    tokens through the exchange's backward) against JAX's apply_ep; the
    output against apply_dense on the rank's tokens alone (routing and
    capacity are per token shard)."""
    ranks, want, params, x = ep_runs
    k = KS[i]
    y, aux, gx, grouter, gw_in, gw_out = want[k]
    t_loc, e_loc = T // N, E // N
    dense = jax.jit(JaxMoE(E, 1.25, k).apply_dense)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for r, got in enumerate(ranks):
        got = got[i]
        rows = slice(r * t_loc, (r + 1) * t_loc)
        slabs = slice(r * e_loc, (r + 1) * e_loc)
        np.testing.assert_allclose(got["y"], y[rows], **F32_TOL, err_msg="y")
        np.testing.assert_allclose(got["aux"], aux[r], **F32_TOL, err_msg="aux")
        np.testing.assert_allclose(got["y"], np.asarray(dense(jparams, jnp.asarray(x[rows]))),
                                   **F32_TOL, err_msg="apply_dense")
        dx, drouter, dw_in, dw_out = got["grads"]
        np.testing.assert_allclose(dx, gx[rows], **F32_TOL, err_msg="dx")
        np.testing.assert_allclose(drouter.T, grouter[r], **F32_TOL, err_msg="drouter")
        np.testing.assert_allclose(dw_in, gw_in[slabs], **F32_TOL, err_msg="dw_in")
        np.testing.assert_allclose(dw_out, gw_out[slabs], **F32_TOL, err_msg="dw_out")


@pytest.mark.parametrize("k", KS)
def test_the_lockstep_exchange_is_apply_dense_shard_by_shard(k):
    """``apply_ep_lockstep`` (the card's one-process expert group) against
    ``apply_dense`` on each virtual rank's tokens, and its gradients
    against theirs: the exchange is a permutation of the slot blocks."""
    params, x, ct = _moe_inputs()
    moe = MoE(E, 1.25, k)
    tp = {"router": torch.tensor(np.ascontiguousarray(params["router"].T), requires_grad=True),
          "w_in": torch.tensor(params["w_in"], requires_grad=True),
          "w_out": torch.tensor(params["w_out"], requires_grad=True)}
    xs = [torch.tensor(c) for c in np.split(x, N)]
    cts = [torch.tensor(c) for c in np.split(ct, N)]
    ys, auxes = moe.apply_ep_lockstep(tp["router"], tp["w_in"], tp["w_out"], xs, with_aux=True)
    g_lock = torch.autograd.grad(sum((y * c).sum() for y, c in zip(ys, cts)) + sum(auxes),
                                 list(tp.values()))
    dense = [moe.apply_dense(tp, xi, with_aux=True) for xi in xs]
    g_dense = torch.autograd.grad(sum((y * c).sum() for (y, _), c in zip(dense, cts))
                                  + sum(a for _, a in dense), list(tp.values()))
    for (y, a), yl, al in zip(dense, ys, auxes):
        torch.testing.assert_close(yl, y, **F32_TOL)
        torch.testing.assert_close(al, a, **F32_TOL)
    for a, b in zip(g_lock, g_dense):
        torch.testing.assert_close(a, b, **F32_TOL)


# -- the vit_moe_tiny forward --------------------------------------------------------


@pytest.fixture(scope="module")
def moe_tiny_params():
    params, _ = jax.jit(jax_vit_moe_tiny().init)(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("k", KS)
def test_vit_moe_tiny_forward_matches_jax(moe_tiny_params, k):
    """Training mode: the logits and the depth-averaged load-balancing loss
    (JAX's ``{"moe_aux_loss"}`` state); eval mode: the logits alone."""
    md = jax_vit_moe_tiny()
    md = type(md)(**{**md.__dict__, "top_k": k})
    params = moe_tiny_params
    x = np.random.default_rng(5).standard_normal((4, 32, 32, 3)).astype(np.float32)
    model = vit_moe.vit_moe_tiny(device="cpu", top_k=k)
    bridge.load_jax_params(model, params)
    logits, state = jax.jit(lambda p, x: md.apply(p, {}, x, train=True))(params, x)
    got, aux = model.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits), **F32_TOL)
    np.testing.assert_allclose(aux.item(), float(state["moe_aux_loss"]), **F32_TOL)
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(torch.from_numpy(x)).numpy(), np.asarray(logits),
                                   **F32_TOL)
    assert bridge.keystr_flatten(bridge.vit_params_to_jax(model)).keys() == \
        bridge.keystr_flatten(params).keys()
