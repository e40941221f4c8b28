"""The port's compressed gradient reduce (``tpu_dist_torch/train/step.py``:
``compressed_pmean``, ``quantized_pmean_flat``) and its stochastic-rounding
stream (``comm/quantize.py::StreamKey``), held against the JAX package's.

``compressed_pmean`` runs on 2 gloo ranks and the JAX function on a
2-device CPU mesh, on the same per-replica gradients and residuals. The
port's ranks are handed the JAX draws (``jax.random.uniform`` under each
replica's ``fold_in`` keys, ``torch_ranks.DrawsKey``), so the int8 codes,
the scales, the mean gradients and the new residuals agree bit for bit:
the same IEEE operations in the same order on both sides, and a sum of
two rows is one rounding either way. The bf16 wire rounds each
gradient and their sum to bf16 once on both sides, so it is exact too.
Under ``int8_ef`` the residuals ``x - q·s`` are one rounding in XLA on
the CPU (a fused multiply-add) and two in the port, so they, and the
mean gradients they feed, agree to the last bit or two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ranks import pmean_rank, run_ranks

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.comm.compat import shard_map
from tpu_dist.comm.quantize import padded_len
from tpu_dist.train import step as jax_step
from tpu_dist_torch.comm import quantize
from tpu_dist_torch.train import optim, step

WORLD = 2
SEED, STEP = 0x1D8, 7
# leaves of 71 elements in all: odd, so the flat vector is padded, and with
# a chunk of 16 each replica's 36-element row ends in a partial chunk
SHAPES = [(3, 5), (7,), (4, 4, 3), (1,)]
CHUNK = 16
L = sum(int(np.prod(s)) for s in SHAPES)
P = padded_len(L, WORLD)


def _grads():
    rng = np.random.default_rng(3)
    return [rng.standard_normal((WORLD,) + s).astype(np.float32) for s in SHAPES]


def _residuals():
    rng = np.random.default_rng(4)
    return {"r1": (rng.standard_normal(WORLD * P) * 1e-2).astype(np.float32),
            "r2": (rng.standard_normal(P) * 1e-2).astype(np.float32)}


def _replica_key(rank):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), STEP), rank)


def _draws(rank, chunk):
    """What the JAX function draws on replica ``rank``, by fold path."""
    m = P // WORLD
    k = -(-m // chunk)
    key = _replica_key(rank)
    return {(1,): np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                                (WORLD, k, chunk), jnp.float32)),
            (2,): np.asarray(jax.random.uniform(jax.random.fold_in(key, 2), (k, chunk),
                                                jnp.float32))}


CASES = {
    "none": ("none", None, None),
    "bf16": ("bf16", None, None),
    "int8": ("int8", CHUNK, None),
    "int8_ef": ("int8_ef", CHUNK, _residuals()),
}


@pytest.fixture(scope="module")
def port_results():
    cases = {name: (mode, chunk, ef, [_draws(r, chunk) for r in range(WORLD)] if chunk else None)
             for name, (mode, chunk, ef) in CASES.items()}
    return run_ranks(pmean_rank, WORLD, cases, _grads(), timeout=120)


def _jax_pmean(mode, chunk, ef):
    mesh = mesh_lib.device_mesh([WORLD], [mesh_lib.DATA_AXIS], jax.devices()[:WORLD])
    ax = mesh_lib.DATA_AXIS
    spec = jax.sharding.PartitionSpec(ax)

    def local(grads, r1, r2):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), STEP),
                                 jax.lax.axis_index(ax))
        res = {"r1": r1, "r2": r2} if ef is not None else ()
        out, new_ef = jax_step.compressed_pmean([g[0] for g in grads], ax, mode, key=key,
                                                ef=res, chunk=chunk)
        new_ef = new_ef or {"r1": r1, "r2": r2}
        return [o[None] for o in out], new_ef["r1"], new_ef["r2"]

    res = ef if ef is not None else {"r1": np.zeros(WORLD * P, np.float32),
                                     "r2": np.zeros(P, np.float32)}
    f = shard_map(local, mesh=mesh, in_specs=(spec, spec, spec),
                  out_specs=(spec, spec, spec), check_vma=False)
    out, r1, r2 = jax.jit(f)(_grads(), res["r1"], res["r2"])
    return [np.asarray(o) for o in out], {"r1": np.asarray(r1), "r2": np.asarray(r2)}


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return a.view(np.uint32)


@pytest.mark.parametrize("name", list(CASES))
def test_compressed_pmean_matches_jax_on_two_ranks(name, port_results):
    mode, chunk, ef = CASES[name]
    want, want_ef = _jax_pmean(mode, chunk, ef)
    for rank, got in enumerate(port_results):
        got = got[name]
        for g, w in zip(got["grads"], want):
            if mode == "int8_ef":
                # XLA's fused x - q·s: 1-2 ulps of the gradients (~1 here)
                np.testing.assert_allclose(g, w[rank], rtol=0, atol=3e-7)
            else:
                np.testing.assert_array_equal(_bits(g), _bits(w[rank]))  # bit for bit
        if mode == "int8_ef":
            for k in ("r1", "r2"):
                # the same fused multiply-add: 1-2 ulps of x (~1) in the residuals
                np.testing.assert_allclose(got["ef"][k], want_ef[k].reshape(WORLD, -1)[rank],
                                           rtol=0, atol=3e-7)
            assert np.abs(got["ef"]["r1"]).max() > 0  # the realised error is carried
        else:
            assert got["ef"] == {}
    counts = port_results[0][name]["counts"]
    if mode in ("int8", "int8_ef"):
        # leg 1: the int8 rows and their scales all-to-all; leg 2: gathered
        assert counts == {"comm.all_to_all.grad": 1, "comm.all_to_all.grad_scale": 1,
                          "comm.all_gather.grad": 1, "comm.all_gather.grad_scale": 1}
    else:
        assert counts == {"comm.all_reduce.grad": 1}


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_the_stream_is_a_pure_function_of_seed_step_and_rank(dtype):
    """The key folds the same bits from an int or a 0-d device tensor (so a
    graph that reads the step count on the device replays the eager
    step's draws); other steps and ranks draw otherwise; the draws are
    uniform on [0, 1) and make the rounding unbiased."""
    a = step.quant_key(5, rank=1).uniform((4, 256), "cpu")
    b = step.quant_key(torch.tensor(5, dtype=dtype), rank=1).uniform((4, 256), "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, step.quant_key(6, rank=1).uniform((4, 256), "cpu"))
    assert not torch.equal(a, step.quant_key(5, rank=0).uniform((4, 256), "cpu"))
    u = step.quant_key(0, rank=0).uniform((200_000,), "cpu")
    assert u.min() >= 0.0 and u.max() < 1.0
    # 2e5 uniform draws: the mean's standard error is 6.5e-4
    assert abs(u.mean().item() - 0.5) < 4e-3
    x = torch.full((200_000,), 0.3) * torch.linspace(-1, 1, 200_000)
    q, s = quantize.quantize_int8(x, 256, step.quant_key(1, rank=0))
    err = (quantize.dequantize_int8(q, s, 256) - x).mean().item()
    # the rounding error of each element is within one step (~2.4e-3 here)
    # with mean 0: the mean of 2e5 of them is within ~4e-6
    assert abs(err) < 2e-5


WALLS = [
    dict(grad_compression="int8", pmean_fusion="per_leaf"),
    dict(shard_weight_update=True, pmean_fusion="per_leaf"),
    dict(rs_ag_chunks=2),
    dict(rs_ag_chunks=2, shard_weight_update=True, grad_compression="int8_ef"),
    dict(rs_ag_chunks=0, shard_weight_update=True),
    dict(grad_compression="fp8"),
]


@pytest.mark.parametrize("kw", WALLS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_the_step_refuses_where_jax_refuses(kw):
    mesh = mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS], jax.devices()[:1])
    with pytest.raises(ValueError) as want:
        jax_step.make_train_step(lambda *a, **k: None, None, mesh, **kw)
    with pytest.raises(ValueError) as got:
        step.make_train_step(optim.SGD(), **kw)
    assert str(got.value) == str(want.value)


def test_the_flat_helpers_lay_out_what_jax_lays_out():
    """The residuals' global zeros at an extent, and AdamW's decay mask in
    flat coordinates: the port's intervals, taken to the JAX ravel order
    (``bridge.jax_ravel_order``), are JAX's ``leaf_wd_intervals``."""
    from torch_ranks import narrow_resnet

    from tpu_dist.train import optim as jax_optim
    from tpu_dist_torch import bridge

    model = narrow_resnet(10, "cpu", 0)
    params = bridge.resnet_params_to_jax(model)[0]
    for n in (1, 3, 4):
        for zero1 in (False, True):
            ours = step.ef_state_host_zeros(model, n, zero1=zero1)
            theirs = jax_step.ef_state_host_zeros(params, n, zero1=zero1)
            assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}
    L = sum(p.numel() for p in model.parameters())

    def mask(intervals):
        out = np.zeros(L, np.float32)
        for start, end, w in intervals:
            out[start:end] = w
        return out

    ours = mask(optim.AdamW(weight_decay=0.05).leaf_wd_intervals(list(model.parameters())))
    theirs = mask(jax_optim.AdamW(weight_decay=0.05).leaf_wd_intervals(params))
    np.testing.assert_array_equal(ours[bridge.jax_ravel_order(model)], theirs)
    assert 0 < np.count_nonzero(theirs) < L  # convs and the fc matrix decay, the rest not
