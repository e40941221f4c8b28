"""The port's pipelined ViT (``tpu_dist_torch/nn/vit_pp.py``) in one
process, held against the JAX package's ``ViTPipelineDef``: the storage
order (``_storage_perm``), the sequential forward at interleave 1 and 2 from
JAX's stacked weights through the bridge, the bridge's round trip of the
stacked layout and each stage's rows (and, under PP×TP, their shards), the
lockstep pipeline of every stage in one process, and the static memory
ledger of a stage."""

import jax
import numpy as np
import pytest
import torch
from pipeline_jax import PP_KW, pp_model, pp_params

from tpu_dist.nn.vit_pp import ViTPipelineDef
from tpu_dist_torch import bridge
from tpu_dist_torch.comm.mesh import AxisGroup
from tpu_dist_torch.nn import vit_pp
from tpu_dist_torch.obs import memory as memory_lib
from tpu_dist_torch.train import optim, state

# f32: the same ops on both sides, XLA's fused LayerNorm, GELU and dots vs
# PyTorch's, a few ulps through 4 blocks (the JAX package's own bound
# between its interleaved and plain forwards is 2e-5)
FWD_TOL = dict(rtol=2e-5, atol=2e-6)


def _images(n=4, seed=1):
    return np.random.default_rng(seed).normal(size=(n, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize("depth,v,s", [(4, 2, 2), (8, 2, 4), (8, 4, 2), (12, 3, 4), (6, 1, 3)])
def test_the_storage_order_is_jaxs(depth, v, s):
    want = ViTPipelineDef(**{**PP_KW, "depth": depth}, interleave=v,
                          pp_stages=s if v > 1 else 0)._storage_perm()
    got = vit_pp.storage_perm(depth, v, s if v > 1 else 0)
    assert (got is None and want is None) or np.array_equal(got, want)


@pytest.mark.parametrize("v", [1, 2])
def test_the_sequential_forward_matches_jax(v):
    """The whole model (no pipe group) from JAX's weights in storage order:
    the logits of ``ViTPipelineDef.apply`` without a pipe axis, which runs
    the blocks back in logical order."""
    md, params = pp_model(v, 2 if v > 1 else 0), pp_params(v, 2 if v > 1 else 0)
    x = _images()
    want, _ = md.apply(jax.tree_util.tree_map(jax.numpy.asarray, params), {}, x)
    model = vit_pp.ViTPipeline(**PP_KW, interleave=v, pp_stages=2 if v > 1 else 0,
                               device="cpu")
    bridge.load_jax_vit(model, params)
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("v", [1, 2])
def test_the_bridge_keeps_the_storage_order(v):
    """JAX's stacked tree -> the port's state dict -> the stacked tree again,
    bit for bit; a stage of a pipe group of 2 loads its ``depth / 2``
    consecutive storage rows, and under PP×TP their Megatron shards."""
    params = pp_params(v, 2 if v > 1 else 0)
    kw = dict(PP_KW, interleave=v, pp_stages=2 if v > 1 else 0, device="cpu")
    whole = bridge.load_jax_vit(vit_pp.ViTPipeline(**kw), params)
    back = bridge.vit_params_to_jax(whole)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    qkv = params["blocks"]["qkv"]["w"]  # [depth, d, 3d], storage order
    for d in range(2):
        stage = bridge.load_jax_vit(vit_pp.ViTPipeline(**kw, pipe=AxisGroup("pipe", 2, d)),
                                    params)
        assert len(stage.blocks) == 2
        for i, blk in enumerate(stage.blocks):
            np.testing.assert_array_equal(blk.qkv.weight.detach().numpy(), qkv[2 * d + i].T)
        for m in range(2):
            shard = bridge.load_jax_vit(vit_pp.ViTPipeline(
                **kw, pipe=AxisGroup("pipe", 2, d), tp=AxisGroup("model", 2, m)), params)
            np.testing.assert_array_equal(shard.blocks[1].qkv.weight.detach().numpy(),
                                          qkv[2 * d + 1].T[48 * m:48 * (m + 1)])
            np.testing.assert_array_equal(shard.head.weight.detach().numpy(),
                                          params["head"]["w"].T)


@pytest.mark.parametrize("v,m", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_the_lockstep_pipeline_is_the_sequential_forward(v, m):
    """The two stages of a pipe group in one process, ``m`` microbatches:
    the logits of the whole model and, through autograd, every stage's
    block gradients (the replicated leaves' are the first stage's)."""
    params = pp_params(v, 2 if v > 1 else 0)
    kw = dict(PP_KW, interleave=v, pp_stages=2 if v > 1 else 0, device="cpu")
    whole = bridge.load_jax_vit(vit_pp.ViTPipeline(**kw), params)
    stages = [bridge.load_jax_vit(vit_pp.ViTPipeline(**kw, pipe=AxisGroup("pipe", 2, d)),
                                  params) for d in range(2)]
    x = torch.from_numpy(_images(8))
    want = whole(x)
    got = vit_pp.pipeline_lockstep_forward(stages, x, m)
    # rows of the batch pass the same ops in either split: bit for bit
    assert torch.equal(got, want)
    want.square().sum().backward()
    got.square().sum().backward()
    for d, s in enumerate(stages):
        for i, blk in enumerate(s.blocks):
            for (n, p), q in zip(blk.named_parameters(), whole.blocks[2 * d + i].parameters()):
                # the weight gradient summed over microbatches vs the batch
                torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-6, msg=n)
    torch.testing.assert_close(stages[0].patch.weight.grad, whole.patch.weight.grad,
                               rtol=1e-5, atol=1e-6)


def test_a_stages_ledger_counts_its_rows_alone():
    """A stage of 2 under PP×TP at 2: its 12 stacked block leaves are
    sharded (half the rows; qkv/mlp1 and proj/mlp2 weights halved again),
    the replicated leaves whole; its bytes a device are its own parameters'."""
    params = pp_params()
    model = bridge.load_jax_vit(vit_pp.ViTPipeline(
        **PP_KW, device="cpu", pipe=AxisGroup("pipe", 2, 0), tp=AxisGroup("model", 2, 1)),
        params)
    sec = memory_lib.static_ledger(**memory_lib.state_sections(
        state.TrainState.create(model, optim.SGD())))["sections"]["params"]
    n_full = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert sec["sharded_leaves"] == 12
    assert sec["bytes_total"] == n_full * 4
    assert sec["bytes_per_device"] == sum(p.numel() for p in model.parameters()) * 4
    assert sec["bytes_per_device"] < sec["bytes_total"]


def test_the_specs_are_jaxs_layouts():
    """``pp_param_specs``, ``tp_param_specs`` and ``pp_tp_param_specs`` name
    the leaves JAX's specs shard, by axis: every block leaf over the pipe
    axis, the Megatron weights and column biases over the model axis too,
    the embedding, positions, ``ln_f`` and head over none."""
    md = pp_model()
    jax_pp = md.pp_tp_param_specs("pipe", "model")["blocks"]
    stage = vit_pp.ViTPipeline(**PP_KW, device="cpu", pipe=AxisGroup("pipe", 2, 1),
                               tp=AxisGroup("model", 2, 0))
    specs = stage.pp_tp_param_specs()
    names = {n for n, _ in stage.named_parameters()}
    assert set(specs) == {n for n in names if n.startswith("blocks.")}
    assert set(stage.pp_param_specs()) == set(specs)
    for name, (axes, dim) in specs.items():
        module, kind = name.split(".")[2:]
        ln = module.startswith("ln")
        key = {"weight": "scale" if ln else "w", "bias": "bias" if ln else "b"}[kind]
        jax_spec = jax_pp[module][key]
        assert jax_spec[0] == "pipe" and ("model" in jax_spec) == (axes == ("pipe", "model")), name
        if axes == ("pipe", "model"):  # JAX's sharded dim of [depth, din, dout] -> torch's
            assert stage.tp_param_specs()[name] == ("model", dim)
