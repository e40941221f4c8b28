"""The port's tensor parallelism (Megatron TP) on gloo ranks held against
the JAX package on its 8 CPU devices: the conjugate pair
(``comm/collectives.py::copy_to_tp``/``reduce_from_tp`` against
``tpu_dist/parallel/tensor.py::tp_ops``) and the column/row-parallel dense
layers; and the TP ViT's forward and gradients at tp 2 and 4 against
JAX's ``apply(tp_axis=)``. The DP x TP step is
``test_torch_tensor_parallel_step.py``, DP x TP x SP
``test_torch_tensor_parallel_3d.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from model_parallel_jax import (SAME_TOL, TP_KW, assert_params, batches, mesh_of, tp_model,
                                tp_params)
from torch_ranks import run_ranks, tp_forward_rank, tp_ops_rank

from tpu_dist.comm.compat import shard_map
from tpu_dist.nn import functional as JF
from tpu_dist.parallel import tensor as jax_tensor

# the conjugate pair and the dense layers: f32 on both sides, one psum of
# 2-4 terms in another order at most, and a tanh GELU: a few f32 ulps of
# values of order 1
OPS_TOL = dict(rtol=1e-5, atol=1e-6)


# -- the conjugate pair and the dense layers ------------------------------------

def _ops_inputs(n):
    """x [n, 3, 8] (a row a rank), the pair's cotangent of x's shape, the
    MLP's [3, 6], and the MLP's weights in JAX's layout, numpy seed 19."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((n, 3, 8)).astype(np.float32)
    ct = rng.standard_normal((n, 3, 8)).astype(np.float32)
    ct_mlp = rng.standard_normal((3, 6)).astype(np.float32)
    w1 = rng.standard_normal((8, 12)).astype(np.float32) / np.sqrt(8)
    b1 = rng.standard_normal(12).astype(np.float32)
    w2 = rng.standard_normal((12, 6)).astype(np.float32) / np.sqrt(12)
    b2 = rng.standard_normal(6).astype(np.float32)
    return x, ct, ct_mlp, w1, b1, w2, b2


def _jax_ops(n, x, ct, ct_mlp, w1, b1, w2, b2):
    mesh = mesh_of([n], ["model"])
    copy, reduce = jax_tensor.tp_ops("model")

    def pair(xl, ctl):
        out = {}
        for name, fn in (("copy", copy), ("reduce", reduce)):
            y, vjp = jax.vjp(fn, xl[0])
            out[name] = (y[None], vjp(ctl[0])[0][None])
        return out

    def mlp(xr, ctr, w1l, b1l, w2l, b2r):
        # the row-parallel layer as the JAX ViT writes it (tp_block_forward:
        # reduce_from_tp of the local product, then the bias); JAX's own
        # row_parallel_dense differentiates through the raw psum, whose
        # transpose is a psum (ROADMAP Queue C), so it is held on its
        # forward alone
        def f(xr, w1l, b1l, w2l, b2r):
            h = jax.nn.gelu(jax_tensor.column_parallel_dense(copy(xr), w1l, "model", b1l))
            return reduce(h @ w2l) + b2r
        y, vjp = jax.vjp(f, xr, w1l, b1l, w2l, b2r)
        h = jax.nn.gelu(jax_tensor.column_parallel_dense(xr, w1l, "model", b1l))
        y_raw = jax_tensor.row_parallel_dense(h, w2l, "model", b2r)
        return y, y_raw, vjp(ctr)

    pair_fn = jax.jit(shard_map(pair, mesh=mesh, in_specs=(P("model"), P("model")),
                                out_specs=P("model"), check_vma=False))
    mlp_fn = jax.jit(shard_map(
        mlp, mesh=mesh, in_specs=(P(), P(), P(None, "model"), P("model"), P("model", None), P()),
        out_specs=(P(), P(), (P(), P(None, "model"), P("model"), P("model", None), P())),
        check_vma=False))
    pairs = pair_fn(x, ct)
    y, y_raw, grads = mlp_fn(x[0], ct_mlp, w1, b1, w2, b2)
    np.testing.assert_allclose(np.asarray(y_raw), np.asarray(y), rtol=1e-6, atol=1e-7)
    return ({k: tuple(np.asarray(a) for a in v) for k, v in pairs.items()},
            (np.asarray(y), [np.asarray(g) for g in grads]))


@pytest.fixture(scope="module")
def ops():
    n = 2
    inputs = _ops_inputs(n)
    return run_ranks(tp_ops_rank, n, *inputs, timeout=60), _jax_ops(n, *inputs)


def test_the_conjugate_pair_matches_tp_ops(ops):
    """copy_to_tp: identity forward, the gradient summed over the group;
    reduce_from_tp: the sum forward, the gradient as it is."""
    ranks, (want, _) = ops
    for name in ("copy", "reduce"):
        for r, got in enumerate(ranks):
            y, g = got[name]
            np.testing.assert_allclose(y, want[name][0][r], **OPS_TOL, err_msg=f"{name} y")
            np.testing.assert_allclose(g, want[name][1][r], **OPS_TOL, err_msg=f"{name} grad")
    x_sum = sum(r["copy"][0] for r in ranks)
    np.testing.assert_allclose(ranks[0]["reduce"][0], x_sum, **OPS_TOL)


def test_column_and_row_parallel_dense_match_jax(ops):
    """gelu(column(copy(x))) then row(...) + b: the output (JAX's
    ``row_parallel_dense``'s too) and the gradients of x (summed through
    copy_to_tp), of each rank's shards (gathered: the torch [out, in] row
    block is JAX's column shard) and of the bias added after the reduce."""
    ranks, (_, (y, (gx, gw1, gb1, gw2, gb2))) = ops
    for got in ranks:
        np.testing.assert_allclose(got["mlp"][0], y, **OPS_TOL, err_msg="y")
        np.testing.assert_allclose(got["mlp"][1][0], gx, **OPS_TOL, err_msg="dx")
        np.testing.assert_allclose(got["mlp"][1][4], gb2, **OPS_TOL, err_msg="db2")
    np.testing.assert_allclose(np.concatenate([r["mlp"][1][1].T for r in ranks], axis=1), gw1,
                               **OPS_TOL, err_msg="dw1")
    np.testing.assert_allclose(np.concatenate([r["mlp"][1][2] for r in ranks]), gb1, **OPS_TOL,
                               err_msg="db1")
    np.testing.assert_allclose(np.concatenate([r["mlp"][1][3].T for r in ranks], axis=0), gw2,
                               **OPS_TOL, err_msg="dw2")
    # a reduce forward and a copy backward in each of the pair test and the MLP
    assert ranks[0]["counts"] == {"comm.all_reduce.tp": 2, "comm.all_reduce.tp_grad": 2}


# -- the TP ViT's forward and gradients ------------------------------------------

TPS = (2, 4)


def _jax_tp_grads(params, x, y, tp):
    md = tp_model()
    specs = md.tp_param_specs("model")

    def local(p, x, y):
        def loss_fn(p):
            logits, _ = md.apply(p, {}, x, tp_axis="model")
            return JF.cross_entropy(logits, y), logits
        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return loss, logits, g

    fn = jax.jit(shard_map(local, mesh=mesh_of([tp], ["model"]), in_specs=(specs, P(), P()),
                           out_specs=(P(), P(), specs), check_vma=False))
    loss, logits, g = fn(jax.tree_util.tree_map(jnp.asarray, params), x, y)
    return float(loss), np.asarray(logits), jax.tree_util.tree_map(np.asarray, g)


@pytest.fixture(scope="module")
def forward():
    params = tp_params()
    x, y, _ = batches(32, 5, n=4, steps=1, seed=3)[0]
    ranks = run_ranks(tp_forward_rank, 4, TPS, TP_KW, params, x, y, timeout=90)
    return ranks, {tp: _jax_tp_grads(params, x, y, tp) for tp in TPS}


@pytest.mark.parametrize("i", range(len(TPS)), ids=[f"tp{t}" for t in TPS])
def test_tp_vit_forward_and_gradients_match_jax(forward, i):
    """Every rank's logits and loss, and its gathered gradients, against
    JAX's shard_map of ``apply(tp_axis="model")`` at the same group size;
    each rank holds heads/tp local heads and the matching column and row
    blocks."""
    ranks, want = forward
    tp = TPS[i]
    loss, logits, grads = want[tp]
    for r in ranks:
        got = r[i]
        np.testing.assert_allclose(got["logits"], logits, **SAME_TOL)
        np.testing.assert_allclose(got["loss"], loss, **SAME_TOL)
        assert_params(got["grads"], grads, SAME_TOL, f"tp={tp} grads")
        assert got["shapes"]["blocks.0.qkv.weight"] == (3 * 32 // tp, 32)
        assert got["shapes"]["blocks.0.proj.weight"] == (32, 32 // tp)
        assert got["shapes"]["blocks.0.mlp2.bias"] == (32,)


@pytest.mark.parametrize("i", range(len(TPS)), ids=[f"tp{t}" for t in TPS])
def test_the_lockstep_tp_group_matches_jax_and_the_gloo_group(forward, i):
    """``nn/vit.py::tp_lockstep_forward``, the one-process TP group of
    chip_smoke.py phase 16 (b): ``tp`` shards of one process, their
    row-parallel partials summed in rank order. The logits against the
    gloo ranks' and JAX's, the loss and the gathered gradients against
    JAX's, at the tolerance of the gloo ranks (the same f32 sums, in rank
    order where gloo's all-reduce may take another)."""
    import torch

    from tpu_dist_torch import bridge
    from tpu_dist_torch.comm import mesh
    from tpu_dist_torch.nn import functional as F
    from tpu_dist_torch.nn import vit

    ranks, want = forward
    tp = TPS[i]
    loss_want, logits_want, grads_want = want[tp]
    x, y, _ = batches(32, 5, n=4, steps=1, seed=3)[0]
    params = tp_params()
    shards = [bridge.load_jax_vit(vit.ViT(**TP_KW, device="cpu",
                                          tp=mesh.AxisGroup(mesh.MODEL_AXIS, tp, r)), params)
              for r in range(tp)]
    logits = vit.tp_lockstep_forward(shards, torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), ranks[0][i]["logits"], **SAME_TOL)
    np.testing.assert_allclose(logits.detach().numpy(), logits_want, **SAME_TOL)
    np.testing.assert_allclose(loss.item(), loss_want, **SAME_TOL)
    specs = shards[0].param_specs()
    named = [dict(s.named_parameters()) for s in shards]
    full = {n: (torch.cat([m[n].grad for m in named], dim=specs[n][1]) if n in specs
                else p.grad) for n, p in named[0].items()}
    grads = bridge.state_dict_to_jax(shards[0], {n: g.numpy() for n, g in full.items()})[0]
    assert_params(grads, grads_want, SAME_TOL, f"lockstep tp={tp} grads")
    assert all(m[n].grad is None for m in named[1:] for n in m if n not in specs)
