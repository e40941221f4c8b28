"""FSDP×TP in the port: FSDP over the data axis of a ``[data 2, model 2]``
mesh on a Megatron ViT (4 gloo ranks), held to JAX's ``compose_fsdp_specs``
and ``make_fsdp_train_step`` on a ``[2, 2]`` CPU mesh. The composed specs
equal JAX's on the same shapes (a dimension the model axis claims is
skipped), and the step matches the port's plain TP step (SGD with
accumulation and clipping, AdamW; their updates are elementwise) and
JAX's FSDP×TP step (SGD, AdamW, LAMB: LAMB's trust ratios are the whole
leaf's norms in both, where the plain TP steps of both packages take each
shard's inside their shard_map) leaf by leaf. A ViT's key biases, whose gradient is 0 in exact arithmetic,
are left out of the AdamW and LAMB comparisons (``fsdp_jax.
assert_close_flats``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from fsdp_jax import (JAX_TOL, TP_KW, assert_close_flats, batches, init_flat, jax_fsdp_run)
from jax.sharding import PartitionSpec as P
from torch_ranks import fsdp_step_rank, run_ranks

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.nn.vit import ViTDef
from tpu_dist.parallel import fsdp as jax_fsdp
from tpu_dist_torch import bridge
from tpu_dist_torch.comm import mesh
from tpu_dist_torch.nn.vit import ViT
from tpu_dist_torch.parallel import fsdp


def _tp_vit(**kw):
    return ViT(**{**TP_KW, **kw}, device="cpu", tp=mesh.AxisGroup("model", 2, 0))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dim", [32, 64])
def test_compose_fsdp_specs_equal_jaxs(n, dim):
    model = _tp_vit(dim=dim)
    params = bridge.jax_layout_template(model)[0]  # full width
    port = fsdp.compose_fsdp_specs(bridge.keystr_leaves(params), n,
                                   bridge.jax_model_specs(model))
    jmesh = mesh_lib.device_mesh([n, 2], ["data", "model"], jax.devices()[:2 * n])
    jtree = jax.tree_util.tree_map(jnp.asarray, params)
    want = jax_fsdp.compose_fsdp_specs(jtree, jmesh,
                                       ViTDef(**{**TP_KW, "dim": dim}).tp_param_specs("model"))
    want = {jax.tree_util.keystr(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, P))[0]}
    assert port == want
    if n == 2:
        assert port["['blocks'][0]['qkv']['w']"] == ("data", "model")
        assert port["['blocks'][0]['proj']['w']"] == ("model", "data")


def test_fsdp_dims_skip_the_model_axis():
    model = _tp_vit()
    dims, specs = fsdp.fsdp_dims(model, 2), model.param_specs()
    assert dims["blocks.0.qkv.weight"] == 1 and specs["blocks.0.qkv.weight"][1] == 0
    assert dims["blocks.0.proj.weight"] == 0 and specs["blocks.0.proj.weight"][1] == 1
    assert all(dims[n] != specs[n][1] for n in dims if n in specs)


CASES = {
    "sgd-accum-clip": dict(model="tp", opt="SGD", flat="SGD",
                           kw=dict(grad_accum_steps=2, grad_clip_norm=0.5)),
    # Adam's lr: its first steps move every entry by ~lr whatever the
    # gradient's size, so an entry whose gradient is a rounding away from 0
    # moves by ~lr times that rounding's share of it
    "adamw": dict(model="tp", opt="AdamW", flat="AdamW", kw={}, lr=1e-3),
    "lamb-clip": dict(model="tp", opt="LAMB", flat="LAMB", kw=dict(grad_clip_norm=1.0), lr=1e-3),
}
HEADS = TP_KW["heads"]
# Adam's steps against JAX: its normalization maps an entry whose gradient
# is near 0 to a step of up to lr whatever the gradient's size, so the two
# packages' rounding of such a gradient moves the entry by a share of lr
# (one entry of 4,096 of an mlp1 kernel by 1.8e-5 at lr 1e-3 over 2 steps):
# each entry within 2% of the 2 lr two steps can move it
ADAM_JAX_TOL = dict(rtol=JAX_TOL["rtol"], atol=0.02 * 2 * 1e-3)


@pytest.fixture(scope="module")
def runs():
    flats = {c["flat"]: init_flat("tp", c["opt"]) for c in CASES.values()}
    port = run_ranks(fsdp_step_rank, 4, list(CASES.values()), flats, batches("tp"),
                     timeout=150)[0]
    return flats, dict(zip(CASES, port))


@pytest.mark.parametrize("name", ["sgd-accum-clip", "adamw"])
def test_the_fsdp_tp_step_is_the_plain_tp_step(runs, name):
    (plain_losses, fsdp_losses), plain, sharded = runs[1][name]
    np.testing.assert_allclose(fsdp_losses, plain_losses, rtol=1e-5)
    assert_close_flats(sharded, plain, f"{name}: FSDP×TP vs TP",
                       heads=HEADS if name != "sgd-accum-clip" else None)


@pytest.mark.parametrize("name", list(CASES))
def test_the_fsdp_tp_step_is_jaxs(runs, name):
    flats, port = runs
    c = CASES[name]
    losses, want = jax_fsdp_run("tp", flats[c["flat"]], batches("tp"), 2, tp=2, opt=c["opt"],
                                lr=c.get("lr"), **c["kw"])
    (_, fsdp_losses), _, sharded = port[name]
    np.testing.assert_allclose(fsdp_losses, losses, rtol=1e-5)
    adam = name != "sgd-accum-clip"
    assert_close_flats(sharded, want, f"{name}: port FSDP×TP vs JAX",
                       tol=ADAM_JAX_TOL if adam else JAX_TOL, heads=HEADS if adam else None)
