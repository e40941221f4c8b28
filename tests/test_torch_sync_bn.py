"""The port's BatchNorm (``tpu_dist_torch.nn.layers.bn_apply``) on 2 gloo
ranks, synced (SyncBN) and per rank, held against the JAX package's
``bn_apply`` under ``shard_map`` on a 2-device CPU mesh: the outputs, the
new running statistics and the gradient of a weighted sum of the output by
the input. Rank r takes the r-th contiguous half of the global batch, as
the JAX mesh's ``data`` axis shards it. The two halves are shifted apart,
so synced and per-rank statistics differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from torch_ranks import bn_rank, run_ranks

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.comm.compat import shard_map
from tpu_dist.nn import layers as L

WORLD = 2
C = 6


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, size=(8, 5, 5, C)).astype(np.float32)
    x[:4] += 3.0  # rank 0's half sits apart from rank 1's
    w = rng.standard_normal(x.shape).astype(np.float32)
    scale = np.linspace(0.5, 1.5, C, dtype=np.float32)
    bias = np.linspace(-0.2, 0.2, C, dtype=np.float32)
    return x, w, scale, bias


CASES = {
    # name: (seed, sync, dtype)
    "sync f32": (0, True, "float32"),
    "per-rank f32": (1, False, "float32"),
    "sync bf16": (2, True, "bfloat16"),
}


def _jax(x, w, scale, bias, sync, dtype):
    mesh = mesh_lib.device_mesh([WORLD], [mesh_lib.DATA_AXIS], jax.devices()[:WORLD])
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    state = {"mean": jnp.zeros(C), "var": jnp.ones(C)}
    axis = mesh_lib.DATA_AXIS if sync else None

    def local(xs, ws):
        y, ns = L.bn_apply(params, state, xs.astype(dtype), train=True, axis_name=axis)
        return y, ns, jnp.sum(y.astype(jnp.float32) * ws)[None]

    f = shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                  out_specs=(P("data"), P() if sync else P("data"), P("data")),
                  check_vma=False)
    y, ns, _ = jax.jit(f)(x, w)
    gx = jax.jit(jax.grad(lambda xs: jnp.sum(f(xs, w)[2])))(x)
    return {"y": np.asarray(y, np.float32), "gx": np.asarray(gx),
            "mean": np.asarray(ns["mean"]), "var": np.asarray(ns["var"])}


@pytest.fixture(scope="module")
def port_results():
    cases = [(*_inputs(seed), sync, dtype) for seed, sync, dtype in CASES.values()]
    ranks = run_ranks(bn_rank, WORLD, cases, timeout=120)
    return {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


# f32: the same statistics summed in another order (two ranks' means then
# their average vs XLA's reduction over the global batch): outputs of
# size ~2 and gradients of size ~3 agree to a few f32 ulps. bf16: both
# sides round x, the centred x and the product to bf16 (one bf16 step is
# 2^-8 relative) but XLA fuses the chain in f32 where PyTorch rounds after
# each op: a few bf16 steps of |y| ~ 2 and of the gradient.
TOL = {"float32": dict(rtol=1e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=5e-2)}
# the statistics are f32 on both sides: a few ulps of mean ~ 0.4, var ~ 1.3
STAT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_bn_on_two_ranks_matches_jax_shard_map(name, port_results):
    seed, sync, dtype = CASES[name]
    want = _jax(*_inputs(seed), sync, getattr(jnp, dtype))
    ranks = port_results[name]
    for key in ("y", "gx"):
        got = np.concatenate([r[key] for r in ranks])
        np.testing.assert_allclose(got, want[key], **TOL[dtype], err_msg=key)
    if sync:  # one global statistic, the same on both ranks
        for key in ("mean", "var"):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
            np.testing.assert_allclose(ranks[0][key], want[key], **STAT_TOL, err_msg=key)
    else:  # rank r's own statistics are the r-th block of the JAX output
        for key in ("mean", "var"):
            got = np.concatenate([r[key] for r in ranks])
            np.testing.assert_allclose(got, want[key], **STAT_TOL, err_msg=key)


def test_sync_changes_the_statistics(port_results):
    """The halves are shifted apart: per-rank means differ by ~0.3 (3 x
    momentum 0.1), synced ones are one value."""
    per_rank = port_results["per-rank f32"]
    assert np.abs(per_rank[0]["mean"] - per_rank[1]["mean"]).min() > 0.2


def test_collectives_on_two_ranks_match_jax():
    """``tpu_dist_torch.comm.collectives`` on 2 gloo ranks against the JAX
    package's traced collectives over the 2-device mesh, rank r holding
    row r; f32 sums of two values, so exact."""
    from tpu_dist.comm import collectives as jax_coll  # noqa: PLC0415
    from torch_ranks import collectives_rank  # noqa: PLC0415

    x = np.random.default_rng(3).standard_normal((WORLD, 4)).astype(np.float32)
    ranks = run_ranks(collectives_rank, WORLD, x, timeout=120)
    mesh = mesh_lib.device_mesh([WORLD], [mesh_lib.DATA_AXIS], jax.devices()[:WORLD])

    def jax_coll_on_rows(fn):
        f = shard_map(lambda r: fn(r[0])[None], mesh=mesh, in_specs=P("data"),
                      out_specs=P("data"), check_vma=False)
        return np.asarray(jax.jit(f)(x))

    want = {
        "reduce_mean": jax_coll_on_rows(jax_coll.reduce_mean),
        "reduce_sum": jax_coll_on_rows(jax_coll.reduce_sum),
        "all_gather": jax_coll_on_rows(jax_coll.all_gather),
        "broadcast_from": jax_coll_on_rows(
            lambda v: jax_coll.broadcast_from(v, src=WORLD - 1)),
    }
    for rank, got in enumerate(ranks):
        for key, rows in want.items():
            np.testing.assert_array_equal(got[key], rows[rank], err_msg=key)
        assert float(got["host_allreduce_mean"]) == 0.5
        np.testing.assert_array_equal(got["broadcast_module"], np.zeros((2, 3), np.float32))
        assert got["input_unchanged"]
        # only the reduces count (kind "other" by default, "host" for the host mean)
        assert got["counts"] == {"comm.all_reduce.other": 1, "comm.all_reduce.test": 1,
                                 "comm.all_reduce.host": 1}
