"""``--device_metrics`` in the port (``tpu_dist_torch/obs/device_stats.py``
and ``make_train_step(device_metrics=True)``) against the JAX package's
(``tpu_dist/obs/device_stats.py``, ``tpu_dist/train/step.py``).

* ``compute_device_stats`` on seeded numpy trees, a NaN leaf, an inf leaf,
  a finite leaf whose squares overflow f32, and an empty tree: the norms
  to rtol 1e-6 (the parameters' sums are f32 in another order than XLA's
  reduction tree, the gradients' f64 rounded to f32), the non-finite leaf
  count exactly, and the overflow giving inf in both.
* The train step with the flag on, at a narrow ResNet and at ``vit_tiny``
  from the same bridged weights on one device, against JAX's step: the
  loss and the four scalars each step. rtol 1e-5: the two steps' gradients
  already differ by f32 summation order (the step tests' 1e-5), and
  ``update_ratio`` divides ``new - old``, whose each element loses the
  digits the update is below the weight (~1e-3 of it), to a norm over
  every element; the non-finite count exactly.
* The flag adds no collective and no launch: the ``comm.*`` counts and the
  kernel wrappers' launch counts equal the flag-off step's, on one device
  and on 2 gloo ranks, whose scalars are the same on both ranks.
* The sharded-path and fused-epoch refusals, word for word JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ranks import free_port, health_step_rank, narrow_resnet, run_ranks

from tests.helpers import TinyMLP
from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.nn import vit as jax_vit
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.obs import device_stats as jax_stats
from tpu_dist.train import optim as jax_optim
from tpu_dist.train import state as jax_state
from tpu_dist.train import step as jax_step
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch import bridge
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.nn import resnet, vit
from tpu_dist_torch.obs import counters
from tpu_dist_torch.obs.device_stats import compute_device_stats, snapshot
from tpu_dist_torch.train import optim, state, step, trainer

STATS = ("grad_norm", "param_norm", "update_ratio", "nonfinite_grads")
NORM_TOL = dict(rtol=1e-6, atol=0)
STEP_TOL = dict(rtol=1e-5, atol=1e-7)
MODEL = dict(block="basic", stage_blocks=(1, 1, 1, 1), num_classes=10, widths=(8, 16, 32, 64))

jax_trainer.register_model("tiny_mlp_health", lambda num_classes=10: TinyMLP(num_classes,
                                                                            in_dim=3072))
trainer.register_model("narrow_resnet", narrow_resnet)


def _tree(seed, poison=None):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": (50,), "c": (2, 3, 3), "d": (7, 1), "e": (64, 9)}
    grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    new = {k: (p - 0.01 * grads[k]).astype(np.float32) for k, p in params.items()}
    if poison == "nan":
        grads["b"][7] = np.nan
    elif poison == "inf":
        grads["c"][1, 2, 0] = -np.inf
        grads["e"][0, 0] = np.nan
    elif poison == "overflow":  # finite, but its square is past f32's range
        grads["d"][3, 0] = 3e19
    return grads, params, new


def _ours(grads, params, new):
    t = lambda d: [torch.from_numpy(np.array(d[k])) for k in sorted(d)]  # noqa: E731
    return {k: v.item() for k, v in compute_device_stats(t(grads), snapshot(t(params)),
                                                         t(new)).items()}


def _theirs(grads, params, new):
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    return {k: float(v) for k, v in jax_stats.compute_device_stats(j(grads), j(params),
                                                                    j(new)).items()}


@pytest.mark.parametrize("poison", [None, "nan", "inf", "overflow"])
@pytest.mark.parametrize("seed", range(3))
def test_compute_device_stats_matches_jax(seed, poison):
    grads, params, new = _tree(seed, poison)
    want = _theirs(grads, params, new)
    got = _ours(grads, params, new)
    assert got["nonfinite_grads"] == want["nonfinite_grads"] == {
        None: 0.0, "nan": 1.0, "inf": 2.0, "overflow": 0.0}[poison]
    for k in ("param_norm", "update_ratio"):
        np.testing.assert_allclose(got[k], want[k], **NORM_TOL, err_msg=k)
    if poison is None:
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **NORM_TOL)
    elif poison == "overflow":  # the f32 sum of squares overflows in both
        assert got["grad_norm"] == want["grad_norm"] == np.inf
    else:
        assert np.isnan(got["grad_norm"]) and np.isnan(want["grad_norm"])


def test_an_empty_tree_gives_zeros_as_in_jax():
    got = _ours({}, {}, {})
    want = _theirs({}, {}, {})
    assert got == want == {k: 0.0 for k in STATS}


def test_consuming_the_params_leaves_the_update_in_them():
    grads, params, new = _tree(0)
    live = [torch.from_numpy(params[k].copy()) for k in sorted(params)]
    before = snapshot(live)
    after = [torch.from_numpy(new[k]) for k in sorted(new)]
    compute_device_stats([torch.from_numpy(grads[k]) for k in sorted(grads)], before, after)
    np.testing.assert_array_equal(before.numpy(), np.concatenate(
        [(params[k] - new[k]).ravel() for k in sorted(params)]))
    for x, k in zip(live, sorted(params)):  # the snapshot is a copy
        np.testing.assert_array_equal(x.numpy(), params[k])


def _batches(n=8, hw=32, steps=2, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
             rng.integers(0, 10, n).astype(np.int32), lr) for lr in (0.1, 0.05)[:steps]]


@functools.lru_cache(maxsize=None)
def _resnet_init():
    """The JAX model and the port's seeded initial weights in the JAX
    layout (numpy), which both sides start from."""
    md = ResNetDef(MODEL["block"], MODEL["stage_blocks"], MODEL["num_classes"],
                   widths=MODEL["widths"])
    params, bn_state = bridge.resnet_params_to_jax(resnet.ResNet(**MODEL, device="cpu", seed=3))
    return md, params, bn_state


def _jax_metrics(apply, params, bn_state, batches, **kw):
    mesh = mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS], jax.devices()[:1])
    # the plain SGD: the fused kernel's Pallas interpret mode would triple
    # the compile, and its update equals the plain one (its own tests)
    opt = jax_optim.SGD(momentum=0.9, weight_decay=1e-4)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    st = jax.device_put(jax_state.TrainState.create(jparams, bn_state, opt),
                        mesh_lib.replicated(mesh))
    jstep = jax_step.make_train_step(apply, opt, mesh, donate=False, device_metrics=True, **kw)
    out = []
    for images, labels, lr in batches:
        st, m = jstep(st, images, labels, lr)
        out.append({k: float(v) for k, v in m.items()})
    return out


def _port_metrics(model, batches, device_metrics=True):
    opt = optim.SGD(momentum=0.9, weight_decay=1e-4, fused=True)
    st = state.TrainState.create(model, opt)
    tstep = step.make_train_step(opt, device_metrics=device_metrics)
    out = []
    for images, labels, lr in batches:
        st, m = tstep(st, images, labels, lr)
        out.append({k: v.item() for k, v in m.items()})
    return out


def _assert_step_stats(got, want):
    for g, w in zip(got, want, strict=True):
        assert set(STATS) <= set(g)
        np.testing.assert_allclose(g["loss"], w["loss"], **STEP_TOL)
        for k in ("grad_norm", "param_norm", "update_ratio"):
            np.testing.assert_allclose(g[k], w[k], **STEP_TOL, err_msg=k)
            assert np.isfinite(g[k]) and g[k] > 0, k
        assert g["nonfinite_grads"] == w["nonfinite_grads"] == 0.0


def test_the_resnet_step_with_device_metrics_matches_jax():
    md, params, bn_state = _resnet_init()
    model = resnet.ResNet(**MODEL, device="cpu")
    bridge.load_jax_resnet(model, params, bn_state)
    batches = _batches(hw=16, steps=1)
    _assert_step_stats(_port_metrics(model, batches),
                       _jax_metrics(md.apply, params, bn_state, batches))


def test_the_vit_step_with_device_metrics_matches_jax():
    # the attention through its plain version on both sides (the flash
    # kernels' own tests hold them; here the subject is the scalars)
    model = vit.vit_tiny(attn_impl="xla", device="cpu")
    params = bridge.numpy_vit_params(model, seed=0)
    bridge.load_jax_vit(model, params)
    batches = _batches(n=4, steps=1)
    _assert_step_stats(_port_metrics(model, batches),
                       _jax_metrics(jax_vit.vit_tiny().apply, params, {}, batches,
                                    model_kwargs={"attn_impl": "xla"}))


def test_the_flag_adds_no_collective_and_no_launch_on_one_device():
    _, params, bn_state = _resnet_init()
    counts = []
    for flag in (False, True):
        model = resnet.ResNet(**MODEL, device="cpu")
        bridge.load_jax_resnet(model, params, bn_state)
        counters.reset()
        metrics = _port_metrics(model, _batches(), device_metrics=flag)
        counts.append(counters.snapshot())
        assert (set(STATS) <= set(metrics[0])) == flag
    assert counts[0] == counts[1]


def test_two_ranks_hold_the_same_scalars_with_the_same_collectives():
    _, params, bn_state = _resnet_init()
    ranks = run_ranks(health_step_rank, 2, MODEL, params, bn_state, _batches(), timeout=240)
    for r in ranks:
        off, on = r[False], r[True]
        assert on["counts"] == off["counts"] and on["launches"] == off["launches"]
        assert off["counts"]["comm.all_reduce.metrics"] == 2  # one a step, flag or not
        for a, b in zip(on["metrics"], off["metrics"], strict=True):
            assert {k: a[k] for k in b} == b  # the same step
    # reduced gradients and parameters are the same on both ranks: so are
    # the scalars, bit for bit
    assert ranks[0][True]["metrics"] == ranks[1][True]["metrics"]


def _jax_error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_the_sharded_path_is_refused_in_jaxs_words():
    mesh = mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS], jax.devices()[:1])
    theirs = _jax_error(lambda: jax_step.make_train_step(
        TinyMLP().apply, jax_optim.SGD(), mesh, shard_weight_update=True, device_metrics=True))
    ours = _jax_error(lambda: step.make_train_step(optim.SGD(), shard_weight_update=True,
                                                   device_metrics=True))
    assert ours == theirs
    ours_body = _jax_error(lambda: step.make_step_body(optim.SGD(), shard_weight_update=True,
                                                       device_metrics=True))
    assert ours_body == theirs


RUN = dict(dataset="synthetic", num_classes=10, batch_size=16, epochs=1, steps_per_epoch=1,
           synthetic_n=64, eval_every=0, device_metrics=True)


@pytest.mark.parametrize("kw", [dict(shard_weight_update=True), dict(fsdp=True),
                                dict(fused_epoch=True, steps_per_epoch=None)],
                         ids=["zero1", "fsdp", "fused_epoch"])
def test_the_trainer_refuses_as_jaxs_does(kw):
    theirs = _jax_error(lambda: jax_trainer.Trainer(
        JaxConfig(model="tiny_mlp_health", **{**RUN, **kw})))
    ours = _jax_error(lambda: trainer.Trainer(
        TrainConfig(model="narrow_resnet", device="cpu", port=free_port(), **{**RUN, **kw})))
    assert ours == theirs
