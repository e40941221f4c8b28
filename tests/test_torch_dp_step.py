"""The port's data-parallel train step (``tpu_dist_torch.train.step``) on 2
gloo ranks, held against the JAX package's ``make_train_step`` on a
2-device CPU mesh over 2 steps: the loss and accuracies, and afterwards
the parameters, the momentum and the BN running statistics.

A narrow ResNet (one BasicBlock per stage, widths 8/16/32/64, 10 classes,
32x32 inputs) with the JAX initial weights carried to the port through the
bridge. Rank r takes the r-th contiguous half of each global batch of 8,
as the mesh's ``data`` axis shards it. Parametrised over SyncBN on/off,
gradient accumulation K = 1/2, and the port's gradient reduce as one flat
all-reduce or one per leaf; plus one bf16 case. The JAX side's
``pmean_fusion`` moves only its collective schedule (the same mean per
element), so one JAX run per (SyncBN, K) holds both of the port's
reduces.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_ranks import dp_step_rank, run_ranks

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.train import optim as jax_optim
from tpu_dist.train import state as jax_state
from tpu_dist.train import step as jax_step

WORLD = 2
MODEL = dict(block="basic", stage_blocks=(1, 1, 1, 1), num_classes=10, widths=(8, 16, 32, 64))
# BN layers (the stem, 2 per block, 3 shortcuts) and parameter leaves
N_BN, N_LEAVES = 12, 38

CASES = {
    f"{'sync' if sync else 'local'}_bn-K{k}-{fusion}": dict(sync_bn=sync, K=k, fusion=fusion)
    for sync in (True, False) for k in (1, 2) for fusion in ("fused", "per_leaf")
}
CASES["bf16-sync_bn-K1-fused"] = dict(sync_bn=True, K=1, fusion="fused", bf16=True)


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


@pytest.fixture(scope="module")
def port_results():
    _, params, bn_state = _init()
    ranks = run_ranks(dp_step_rank, WORLD, CASES, MODEL, params, bn_state, _batches(),
                      timeout=240)
    return ranks


_JAX_RUNS = {}


def _jax_run(sync_bn, K, bf16):
    key = (sync_bn, K, bf16)
    if key not in _JAX_RUNS:
        md, params, bn_state = _init()
        mesh = mesh_lib.device_mesh([WORLD], [mesh_lib.DATA_AXIS], jax.devices()[:WORLD])
        opt = jax_optim.SGD(momentum=0.9, weight_decay=1e-4)
        st = jax.device_put(jax_state.TrainState.create(params, bn_state, opt),
                            mesh_lib.replicated(mesh))
        step = jax_step.make_train_step(
            md.apply, opt, mesh, grad_accum_steps=K, sync_bn=sync_bn, donate=False,
            compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
        metrics = []
        for images, labels, lr in _batches():
            st, m = step(st, images, labels, lr)
            metrics.append({k: float(v) for k, v in m.items()})
        _JAX_RUNS[key] = (metrics, jax.device_get(st))
    return _JAX_RUNS[key]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


# f32: the same step on both sides in another summation order (cuDNN-free
# CPU convolutions vs XLA's, two ranks' statistics and gradients averaged
# vs one reduction): losses (~2.5) to a few ulps; after two SGD steps at
# lr <= 0.1 every weight, momentum and running-statistic entry (sizes up
# to ~3) to ~1e-6. Accuracies count the same top-k hits.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=2e-5, atol=5e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_matches_jax(name, port_results):
    case = CASES[name]
    want_metrics, want = _jax_run(case["sync_bn"], case["K"], case.get("bf16", False))
    ranks = [r[name] for r in port_results]
    # every rank ends with the same metrics and state
    for key in ("params", "momentum", "bn_state"):
        for a, b in zip(_leaves(ranks[0][key]), _leaves(ranks[1][key])):
            np.testing.assert_array_equal(a, b, err_msg=key)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    got = ranks[0]
    if case.get("bf16"):
        # bf16 compute over f32 masters: the two frameworks round activations
        # at other points (XLA keeps f32 inside fused chains, PyTorch rounds
        # after each op), a few bf16 steps (2^-8 relative) each. The loss
        # (~2.3) to 2e-3 relative, the limit of the ViT's bf16 step test
        # (test_torch_train_step_variants.py). At this size (random labels,
        # 4 images a rank) the gradients are mostly rounding noise: JAX's own
        # bf16 momentum differs from its f32 momentum by 10-60% relative L2
        # per leaf. So the port's leaves must lie, typically (the median),
        # no farther from JAX's bf16 leaves than those lie from the f32
        # ones, and each within 1.5 times that (noise of one draw).
        for g, w in zip(got["metrics"], want_metrics):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=2e-3)
        f32 = _jax_run(case["sync_bn"], case["K"], False)[1]
        ratios = [np.linalg.norm(a - b) / np.linalg.norm(b - f)
                  for a, b, f in zip(_leaves(got["momentum"]), _leaves(want.opt_state),
                                     _leaves(f32.opt_state))]
        assert np.median(ratios) <= 1.0 and max(ratios) <= 1.5, ratios
        return
    for g, w in zip(got["metrics"], want_metrics):
        np.testing.assert_allclose(g["loss"], w["loss"], **LOSS_TOL)
        assert g["acc1"] == pytest.approx(w["acc1"]) and g["acc5"] == pytest.approx(w["acc5"])
    for key, theirs in (("params", want.params), ("momentum", want.opt_state),
                        ("bn_state", want.bn_state)):
        ours = got[key]
        assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, theirs))
        for a, b in zip(_leaves(ours), _leaves(theirs)):
            np.testing.assert_allclose(a, b, **STATE_TOL, err_msg=key)


@pytest.mark.parametrize("name", [n for n in CASES if "bf16" not in n])
def test_collectives_per_step(name, port_results):
    """Two steps: the gradient reduce once a step after the K chunks (one
    flat all-reduce, or one per leaf), the metrics in one all-reduce a
    step, SyncBN's statistics once per BN layer per chunk (and once more in
    the backward), or the running statistics averaged once a step."""
    case, counts = CASES[name], port_results[0][name]["counts"]
    steps, k = 2, case["K"]
    want = {
        "comm.all_reduce.grad": steps * (1 if case["fusion"] == "fused" else N_LEAVES),
        "comm.all_reduce.metrics": steps,
    }
    if case["sync_bn"]:
        want["comm.all_reduce.bn"] = want["comm.all_reduce.bn_grad"] = steps * k * N_BN
    else:
        want["comm.all_reduce.bn_state"] = steps
    assert counts == want
