"""ZeRO-1 weight-update sharding in the port (``shard_weight_update``,
``tpu_dist_torch/train/step.py::_ZeroOne``) on 2 gloo ranks, held against
the JAX package's ``make_train_step(shard_weight_update=True)`` on a
2-device CPU mesh over 2 steps, from the same narrow ResNet weights: the
metrics, the parameters, and the flat optimizer state as the checkpoint
writes it (gathered from the ranks, in the JAX ravel order), which must be
JAX's own flat state. SGD through the fused update (one flat leaf) and
AdamW with its ``auto`` decay mask in flat coordinates
(``leaf_wd_intervals``); ``rs_ag_chunks=2`` moves only the collectives'
schedule, so it gives ``rs_ag_chunks=1``'s state bit for bit.

ZeRO-1's int8 leg is held to JAX's on a probe model instead
(``torch_ranks.Probe``): the port ravels a ResNet's parameters in another
order than JAX (``bridge.jax_ravel_order``), so there the int8 chunks
group other entries, and the convolutions' gradients differ in their last
bits, which can move a code. The probe's flat vector and gradients are
the same in both packages, and the port is handed JAX's draws.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_ranks import run_ranks, zero1_rank

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.train import optim as jax_optim
from tpu_dist.train import state as jax_state
from tpu_dist.train import step as jax_step

WORLD = 2
MODEL = dict(block="basic", stage_blocks=(1, 1, 1, 1), num_classes=10, widths=(8, 16, 32, 64))
CASES = {
    "sgd": dict(optimizer="sgd"),
    "sgd-rs_ag_chunks2": dict(optimizer="sgd", rs_ag_chunks=2),
    # AdamW's step is ~lr on every entry whatever the gradient's size, so an
    # entry whose gradient is near 0 takes the low bits the two summation
    # orders set apart into its step: at lr 0.1 up to ~2e-4 apart. AdamW
    # runs at its own scale, lr 1e-3 (as tests/test_torch_optim.py)
    "adamw": dict(optimizer="adamw", lr_scale=0.01),
    "sgd-int8_ef": dict(optimizer="sgd", wire="int8_ef"),
}


def _batches():
    rng = np.random.default_rng(5)
    return [(rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, 8).astype(np.int32), lr) for lr in (0.1, 0.05)]


@functools.lru_cache(maxsize=None)
def _init():
    md = ResNetDef(MODEL["block"], MODEL["stage_blocks"], MODEL["num_classes"],
                   widths=MODEL["widths"])
    params, bn_state = jax.jit(md.init)(jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return md, to_np(params), to_np(bn_state)


# -- the int8 wire of ZeRO-1, on a probe model (torch_ranks.Probe) ----------
# Its flat vector is the same in both packages, and so is each gradient
# (0.5/8 times a sum of two inputs: exact), so the int8 chunks, the codes
# and everything after them can be held to JAX's given JAX's draws.
PROBE_LENS = (300, 213)  # L = 513: odd, so each rank's 257-entry row ends in a pad
PROBE_CLASSES, PROBE_CHUNK = 8, 64  # a partial int8 chunk at each row's end
PROBE_CASES = {
    "int8": dict(wire="int8", clip=0.0, chunk=PROBE_CHUNK),
    # the clip binds at every step (the gradient norms are 7.4-8.9)
    "int8_ef-clip": dict(wire="int8_ef", clip=4.0, chunk=PROBE_CHUNK),
}


def _probe_inputs():
    rng = np.random.default_rng(8)
    L = sum(PROBE_LENS)
    params = {"a": rng.standard_normal(PROBE_LENS[0]).astype(np.float32),
              "b": rng.standard_normal(PROBE_LENS[1]).astype(np.float32)}
    # per-entry magnitudes over three decades, so the chunks' scales differ;
    # labels never 0, so the cotangent of the probe's logit is 1/8 · 1/2
    batches = [((rng.standard_normal((4, L)) * np.exp(rng.uniform(-3, 3, L))).astype(np.float32),
                rng.integers(1, PROBE_CLASSES, 4).astype(np.int32), lr) for lr in (0.1, 0.05, 0.1)]
    return params, batches


def _probe_draws():
    """``draws[step][rank]``: what JAX's ZeRO-1 int8 leg draws on that
    replica at that step (``quant_key(step)``, no further fold)."""
    m = -(-sum(PROBE_LENS) // WORLD)
    k = -(-m // PROBE_CHUNK)
    return [[np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0x1D8), s), r),
        (WORLD, k, PROBE_CHUNK), jnp.float32)) for r in range(WORLD)] for s in range(3)]


@pytest.fixture(scope="module")
def port_results():
    _, params, bn_state = _init()
    probe_params, probe_batches = _probe_inputs()
    probe = (PROBE_CASES, probe_params, PROBE_CLASSES, probe_batches, _probe_draws())
    return run_ranks(zero1_rank, WORLD, CASES, MODEL, params, bn_state, _batches(), probe,
                     timeout=180)


@functools.lru_cache(maxsize=None)
def _jax_run(optimizer):
    md, params, bn_state = _init()
    mesh = mesh_lib.device_mesh([WORLD], [mesh_lib.DATA_AXIS], jax.devices()[:WORLD])
    opt = (jax_optim.AdamW(weight_decay=0.05) if optimizer == "adamw"
           else jax_optim.SGD(momentum=0.9, weight_decay=1e-4))
    st = jax.device_put(jax_state.TrainState.create(params, bn_state, opt),
                        mesh_lib.replicated(mesh))
    st = st._replace(opt_state=jax_step.init_sharded_opt_state(params, mesh, optimizer=opt))
    step = jax_step.make_train_step(md.apply, opt, mesh, shard_weight_update=True, donate=False)
    metrics = []
    for images, labels, lr in _batches():
        st, m = step(st, images, labels, lr * (0.01 if optimizer == "adamw" else 1.0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(st)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


# f32, as tests/test_torch_dp_step.py: the same step in another summation
# order; the loss to a few ulps, every weight and optimizer entry after two
# steps at lr <= 0.1 to ~1e-6 (AdamW's first steps move each weight by ~lr,
# its moments hold g and g², ~1e-5 apart at most)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=2e-5, atol=5e-6)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_zero1_step_matches_jax(name, port_results):
    want_metrics, want = _jax_run(CASES[name]["optimizer"])
    got = [r[name] for r in port_results]
    assert got[0]["metrics"] == got[1]["metrics"]
    for g, w in zip(got[0]["metrics"], want_metrics):
        np.testing.assert_allclose(g["loss"], w["loss"], **LOSS_TOL)
        assert (g["acc1"], g["acc5"]) == (w["acc1"], w["acc5"])
    for a, b in zip(_leaves(got[0]["params"]), _leaves(got[1]["params"])):
        np.testing.assert_array_equal(a, b)  # the all-gather: one copy on every rank
    for a, b in zip(_leaves(got[0]["params"]), _leaves(want.params)):
        np.testing.assert_allclose(a, b, **STATE_TOL)
    opt = got[0]["opt"]
    if name == "adamw":
        # the moments hold 0.1·g (|g| <= ~0.05) and 0.001·g²: the gradients'
        # summation orders (~1e-6 of the largest) set them ~5e-8 and ~5e-11 apart
        for k, atol in (("mu", 2e-7), ("nu", 2e-10)):
            np.testing.assert_allclose(opt[f"['opt_state'][{k!r}]"], np.asarray(want.opt_state[k]),
                                       rtol=2e-5, atol=atol)
        assert int(opt["['opt_state']['count']"]) == int(want.opt_state["count"]) == 2
    else:
        flat = opt["['opt_state']"]
        np.testing.assert_allclose(flat, np.asarray(want.opt_state), **STATE_TOL)
        L = sum(x.size for x in _leaves(want.params))
        assert flat.shape == (-(-L // WORLD) * WORLD,) and not flat[L:].any()  # the zero pad
    # each rank keeps only its shard of it
    assert got[0]["local_opt"].size == -(-sum(x.size for x in _leaves(want.params)) // WORLD)
    counts = got[0]["counts"]
    assert counts["comm.reduce_scatter.grad"] == 2 and counts["comm.all_gather.params"] == 2
    assert "comm.all_reduce.grad" not in counts


def test_rs_ag_chunks_moves_only_the_schedule(port_results):
    one, two = port_results[0]["sgd"], port_results[0]["sgd-rs_ag_chunks2"]
    assert one["metrics"] == two["metrics"]
    for a, b in zip(_leaves(one["params"]), _leaves(two["params"])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(one["opt"]["['opt_state']"], two["opt"]["['opt_state']"])
    # two column groups: two reduce-scatters and two all-gathers a step
    assert two["counts"]["comm.reduce_scatter.grad"] == 4
    assert two["counts"]["comm.all_gather.params"] == 4


def test_zero1_on_the_int8_ef_wire(port_results):
    """The quantized reduce-scatter leg with its residual row: JAX's draws
    are another stream, so the run is held to the f32 ZeRO-1 run within
    the quantisation step: each replica's row is rounded to int8 in chunks
    of 256 (a relative step of 1/127 of the chunk's largest entry), which
    moves the two steps' loss by well under 1%."""
    f32, q = port_results[0]["sgd"], port_results[0]["sgd-int8_ef"]
    for a, b in zip(f32["metrics"], q["metrics"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-2)
    r1 = q["opt"]["['ef']['r1']"]
    assert r1.shape == (WORLD * f32["local_opt"].size * WORLD,) and np.abs(r1).max() > 0
    assert "['ef']['r2']" not in q["opt"]  # ZeRO-1 keeps the send-side residual only
    assert q["counts"]["comm.all_to_all.grad"] == 2
    assert "comm.reduce_scatter.grad" not in q["counts"]


def _probe_apply(params, bn_state, x, train=True, axis_name=None):
    flat = jnp.concatenate([params["a"], params["b"]])
    s = jnp.sum((flat - jax.lax.stop_gradient(flat)) * x, axis=-1)
    return jnp.pad(s[:, None], ((0, 0), (0, PROBE_CLASSES - 1))), bn_state


def _jax_probe_run(wire, clip, chunk):
    params, batches = _probe_inputs()
    mesh = mesh_lib.device_mesh([WORLD], [mesh_lib.DATA_AXIS], jax.devices()[:WORLD])
    opt = jax_optim.SGD(momentum=0.9, weight_decay=1e-4)
    st = jax.device_put(jax_state.TrainState.create(params, {}, opt), mesh_lib.replicated(mesh))
    st = st._replace(opt_state=jax_step.init_sharded_opt_state(params, mesh, optimizer=opt))
    if wire == "int8_ef":
        st = st._replace(ef=jax_step.init_ef_state(params, mesh, zero1=True))
    step = jax_step.make_train_step(_probe_apply, opt, mesh, shard_weight_update=True,
                                    grad_compression=wire, quant_chunk=chunk,
                                    grad_clip_norm=clip, donate=False)
    losses = []
    for images, labels, lr in batches:
        st, m = step(st, images, labels, lr)
        losses.append(float(m["loss"]))
    return losses, jax.device_get(st)


@pytest.mark.parametrize("name", list(PROBE_CASES))
def test_zero1_int8_wire_matches_jax_given_its_draws(name, port_results):
    """ZeRO-1's own int8 leg (``_ZeroOne.update``): the rows quantized
    under ``quant_key(step, rank)`` with no further fold, the int8
    all-to-all, no second leg, the ``r1`` residual carried into the next
    step under ``int8_ef``, the clip by the shards' norm, SGD on the flat
    shard and the all-gather, over three steps, held to JAX's
    ``make_train_step(shard_weight_update=True, grad_compression=...)``
    with the same draws: the parameters, the flat momentum and ``['ef']
    ['r1']`` in the JAX global layout."""
    kw = PROBE_CASES[name]
    want_losses, want = _jax_probe_run(kw["wire"], kw["clip"], kw["chunk"])
    got = [r["probe"][name] for r in port_results]
    for g in got:
        np.testing.assert_allclose(g["losses"], want_losses, rtol=1e-6)  # log 8, to an ulp
    # Every int8 code is JAX's: a code one off moves its gradient entry by a
    # whole step (1/127 of its chunk's largest, ~1e-3 to ~2e-2 here) and
    # the weight and momentum by lr times that. What is left is rounding:
    # SGD's update and the residual x - q·s are fused multiply-adds in XLA
    # on the CPU, two roundings each in the port, so the parameters and
    # momentum (entries up to ~3.2) agree to 2 ulps there, 5e-7, and r1
    # to an ulp or two of x (entries up to ~1.3), 3e-7
    for k in ("a", "b"):
        np.testing.assert_allclose(got[0][k], want.params[k], rtol=0, atol=5e-7)
        np.testing.assert_array_equal(got[0][k], got[1][k])  # one copy on every rank
    np.testing.assert_allclose(np.concatenate([g["mom"] for g in got]), want.opt_state,
                               rtol=0, atol=5e-7)
    if kw["wire"] == "int8_ef":
        r1 = np.concatenate([g["r1"] for g in got])
        np.testing.assert_allclose(r1, want.ef["r1"], rtol=0, atol=3e-7)
        assert np.abs(r1).max() > 1e-3  # the realised error is carried
    else:
        assert got[0]["r1"] is None
    counts = got[0]["counts"]
    assert counts["comm.all_to_all.grad"] == 3 and "comm.all_gather.grad" not in counts
