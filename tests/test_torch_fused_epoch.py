"""The port's fused epoch (``tpu_dist_torch.train.epoch``) held against the
JAX package's ``tpu_dist/train/epoch.py`` on the CPU.

A narrow ResNet (one BasicBlock per stage, widths 8/16/32/64, 10 classes)
on 64 uint8 images of 16x16, the JAX initial weights carried to the port
through the bridge, plain SGD (momentum 0.9, weight decay 1e-4),
8 images a rank a step, 2 epochs at lr 0.02. The JAX side is ``make_fused_epoch`` on
a 1- and a 2-device CPU mesh; the port's ``run`` takes, rank by rank, the
order and crop offsets that JAX draws inside its ``shard_map``, recomputed
here as ``epoch.py:128,141-142`` draw them (a wrong recomputation would
fail the comparison, so the test checks itself). The port's ranks are gloo
processes (``tests/torch_ranks.py``) with SyncBN over them.

Also: ``put_dataset_on_device`` rank by rank, ``make_fused_eval``'s exact
counts on 131 examples over 2 ranks, and the port's fused ``run`` against
its own ``make_train_step`` fed the same batches, bit for bit.
"""

import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ranks import fused_epoch_rank, fused_eval_rank, run_ranks

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.train import epoch as jax_epoch
from tpu_dist.train import optim as jax_optim
from tpu_dist.train import state as jax_state
from tpu_dist_torch import bridge
from tpu_dist_torch.data.transforms import CIFAR100_MEAN, CIFAR100_STD
from tpu_dist_torch.nn import resnet
from tpu_dist_torch.train import epoch, optim, state, step

MODEL = dict(block="basic", stage_blocks=(1, 1, 1, 1), num_classes=10, widths=(8, 16, 32, 64))
# lr 0.02, as the trainer's parity test: at lr 0.1 this small problem is
# chaotic at 2 ranks (4 steps an epoch): a 1e-7 relative perturbation of
# the initial weights moves the port's own second-epoch loss by 7e-4
# relative and its weights by 1e-2, so no framework could match another
# there; at 0.05 and 0.02 the same perturbation moves them by ulps.
N, SIZE, BATCH, LR, EPOCHS = 64, 16, 8, 0.02, 2

# (world, pad, bf16[, grad_compression]) of each case
CASES = {
    "w1-f32-pad0": (1, 0, False), "w1-f32-pad4": (1, 4, False),
    "w2-f32-pad0": (2, 0, False), "w2-f32-pad4": (2, 4, False),
    "w2-bf16-pad4": (2, 4, True), "w2-f32-pad0-wire_bf16": (2, 0, False, "bf16"),
}


@functools.lru_cache(maxsize=None)
def _init():
    md = ResNetDef(MODEL["block"], MODEL["stage_blocks"], MODEL["num_classes"],
                   widths=MODEL["widths"])
    params, bn_state = jax.tree_util.tree_map(np.asarray,
                                              jax.jit(md.init)(jax.random.PRNGKey(0)))
    return md, params, bn_state


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, 10, n).astype(np.int32))


def _mesh(world):
    return mesh_lib.device_mesh([world], [mesh_lib.DATA_AXIS], jax.devices()[:world])


def _jax_draws(epoch_idx, world, n_local, pad):
    """Per device, the order and offsets the JAX runner draws in epoch
    ``epoch_idx``: ``base = fold_in(fold_in(PRNGKey(0), epoch), dev)``, a
    permutation of the shard by ``base`` cut into batches, and step i's
    offsets by ``randint(fold_in(base, i + 1), (B, 2), 0, 2·pad + 1)``."""
    steps = n_local // BATCH
    out = []
    for dev in range(world):
        base = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), epoch_idx), dev)
        perm = np.asarray(jax.random.permutation(base, n_local))
        offsets = np.stack([
            np.asarray(jax.random.randint(jax.random.fold_in(base, i + 1), (BATCH, 2), 0,
                                          2 * pad + 1)) for i in range(steps)])
        out.append((perm[:steps * BATCH].reshape(steps, BATCH).astype(np.int64),
                    offsets.astype(np.int64)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(world, pad, bf16, wire="none"):
    md, params, bn_state = _init()
    mesh = _mesh(world)
    dx, dy = jax_epoch.put_dataset_on_device(mesh, *_data())
    opt = jax_optim.SGD(momentum=0.9, weight_decay=1e-4)
    st = jax.device_put(jax_state.TrainState.create(params, bn_state, opt),
                        mesh_lib.replicated(mesh))
    runner = jax_epoch.make_fused_epoch(
        md.apply, opt, mesh, batch_per_device=BATCH, pad=pad,
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32, grad_compression=wire)
    metrics = []
    for e in range(EPOCHS):
        st, m = runner(st, dx, dy, LR, e)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(st)


@pytest.fixture(scope="module")
def port_results():
    _, params, bn_state = _init()
    images, labels = _data()
    out = {}
    for world in (1, 2):
        cases = {}
        for name, (w, pad, bf16, *wire) in CASES.items():
            if w == world:
                draws = [_jax_draws(e, world, N // world, pad) for e in range(EPOCHS)]
                cases[name] = dict(pad=pad, bf16=bf16, batch=BATCH, lr=LR, draws=draws,
                                   wire=(wire or ["none"])[0])
        out[world] = run_ranks(fused_epoch_rank, world, cases, MODEL, params, bn_state,
                               images, labels, timeout=240)
    return out


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


# f32 without crops: the same steps on both sides in another summation
# order (the CPU's convolutions vs XLA's; at 2 ranks two ranks' statistics
# and gradients averaged vs one reduction): the epoch-mean loss (~2.5) to
# a few ulps, held to 1e-4 relative; after 2 epochs of SGD every
# weight, momentum and running-statistic entry (sizes up to ~3) to ~1e-6,
# held to 2e-5 + 5e-6, the limits of the data-parallel step's test
# (tests/test_torch_dp_step.py).
LOSS_RTOL = 1e-4
STATE_TOL = dict(rtol=2e-5, atol=5e-6)
# f32 with crops (pad 4, zero-padded borders): XLA's own f32 gradients on
# such inputs are up to ~1% off an f64 evaluation on the CPU (ROADMAP
# Queue C; tests/test_torch_resnet.py::test_f32_gradients_on_cropped_inputs_match_f64),
# so the epoch-mean loss is held to Queue C's 2e-3 relative, as the
# trainer's parity test is (tests/test_torch_trainer.py).
CROP_LOSS_RTOL = 2e-3
# bf16 compute over f32 masters: XLA keeps f32 inside fused chains where
# PyTorch rounds after each op, a few bf16 steps (2^-8 relative) each. The
# first epoch's loss (4 steps) is held to Queue C's bf16 limit, 2e-3
# relative (measured 1.2e-3). The drift compounds after that: JAX's own
# bf16 loss lies 1.5e-2 from its f32 loss in the second epoch, the port's
# 5.7e-3 from JAX's bf16. So the state is held as Queue C holds the bf16
# data-parallel step (tests/test_torch_dp_step.py): the port's momentum
# leaves must lie, typically (the median), no farther from JAX's bf16
# leaves than those lie from JAX's f32 ones, and each within 1.5 times
# that (measured: median 0.87, largest 1.22).
BF16_LOSS_RTOL = 2e-3


@pytest.mark.parametrize("name", list(CASES))
def test_fused_epoch_matches_jax(name, port_results):
    world, pad, bf16, *wire = CASES[name]
    want_metrics, want = _jax_run(world, pad, bf16, *wire)
    ranks = [r[name] for r in port_results[world]]
    for other in ranks[1:]:  # every rank ends with the same metrics and state
        assert other["metrics"] == ranks[0]["metrics"]
        for key in ("params", "momentum", "bn_state"):
            for a, b in zip(_leaves(ranks[0][key]), _leaves(other[key])):
                np.testing.assert_array_equal(a, b, err_msg=key)
    got = ranks[0]
    assert got["step"] == int(want.step) == EPOCHS * (N // world // BATCH)
    if wire:
        # the bf16 wire rounds each mean gradient to bf16 on both sides;
        # where the two f32 means straddle a rounding boundary they round
        # one bf16 step (2^-8) apart, and that moves the weights more than
        # f32's summation order does. The losses keep f32's limit; the
        # leaves are held as the bf16 compute case holds them: typically
        # (the median) no farther from JAX's bf16-wire leaves than those
        # lie from JAX's f32-wire ones, each within 1.5 times that
        # (measured: medians 0.52 and 0.66, largest 0.65 and 0.78).
        for g, w in zip(got["metrics"], want_metrics):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        f32 = _jax_run(world, pad, bf16)[1]
        for key, theirs, plain in (("params", want.params, f32.params),
                                   ("momentum", want.opt_state, f32.opt_state)):
            ratios = [np.linalg.norm(a - b) / max(np.linalg.norm(b - f), 1e-30)
                      for a, b, f in zip(_leaves(got[key]), _leaves(theirs), _leaves(plain))]
            assert np.median(ratios) <= 1.0 and max(ratios) <= 1.5, (key, ratios)
        return
    if bf16:
        np.testing.assert_allclose(got["metrics"][0]["loss"], want_metrics[0]["loss"],
                                   rtol=BF16_LOSS_RTOL)
        f32 = _jax_run(world, pad, False)[1]
        ratios = [np.linalg.norm(a - b) / np.linalg.norm(b - f)
                  for a, b, f in zip(_leaves(got["momentum"]), _leaves(want.opt_state),
                                     _leaves(f32.opt_state))]
        assert np.median(ratios) <= 1.0 and max(ratios) <= 1.5, ratios
        return
    for g, w in zip(got["metrics"], want_metrics):
        np.testing.assert_allclose(g["loss"], w["loss"],
                                   rtol=CROP_LOSS_RTOL if pad else LOSS_RTOL)
    if pad:
        return
    for g, w in zip(got["metrics"], want_metrics):
        # the same top-k hits, averaged over the same steps
        assert g["acc1"] == pytest.approx(w["acc1"]) and g["acc5"] == pytest.approx(w["acc5"])
    for key, theirs in (("params", want.params), ("momentum", want.opt_state),
                        ("bn_state", want.bn_state)):
        for a, b in zip(_leaves(got[key]), _leaves(theirs)):
            np.testing.assert_allclose(a, b, **STATE_TOL, err_msg=key)


def test_put_dataset_on_device_matches_jax_rank_by_rank(port_results):
    images, labels = _data()
    dx, dy = jax_epoch.put_dataset_on_device(_mesh(2), images, labels)
    for array, i in ((dx, 0), (dy, 1)):
        shards = sorted(array.addressable_shards, key=lambda s: s.device.id)
        for rank, shard in enumerate(shards):
            got = port_results[2][rank]["data"][i]
            np.testing.assert_array_equal(got, np.asarray(shard.data))
    assert port_results[2][0]["data"][0].dtype == np.uint8
    assert port_results[2][0]["data"][1].dtype == np.int64


def test_fused_eval_counts_exactly_over_two_ranks():
    md, params, bn_state = _init()
    n = 131  # a multiple of neither the world nor the batch
    images, labels = _data(n, seed=3)
    pad = (-n) % 2
    images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
    labels = np.concatenate([labels, np.full(pad, -1, labels.dtype)])
    mesh = _mesh(2)
    st = jax.device_put(jax_state.TrainState.create(params, bn_state, jax_optim.SGD()),
                        mesh_lib.replicated(mesh))
    ev = jax_epoch.make_fused_eval(md.apply, mesh, batch_per_device=4,
                                   compute_dtype=jnp.float32)
    want = {k: float(v) for k, v in
            ev(st, *jax_epoch.put_dataset_on_device(mesh, images, labels)).items()}
    got = run_ranks(fused_eval_rank, 2, MODEL, params, bn_state, images, labels, 4)
    assert got[0] == got[1]
    assert got[0]["count"] == want["count"] == n
    # f32 logits of the same weights in another summation order: the hit
    # counts agree but for a near-tie (none at this size); the loss sum
    # (~300) to a few ulps of its terms.
    assert got[0]["top1"] == want["top1"] and got[0]["top5"] == want["top5"]
    np.testing.assert_allclose(got[0]["loss"], want["loss"], rtol=1e-5)


def test_fused_run_equals_the_train_step_bit_for_bit():
    """One rank, no process group, f32: the fused ``run`` and
    ``make_train_step`` fed the batches the run gathers (computed here in
    numpy, the JAX runner's formula) give the same losses and state, bit
    for bit: the same step body on the same inputs."""
    _fused_run_against_the_train_step("none")


def test_fused_run_on_the_int8_ef_wire_equals_the_train_step_bit_for_bit():
    """The same on the int8_ef wire: the fused step keys its rounding on
    its device step count (the run's first step plus its counter), the
    eager step on ``state.step``, so both draw the same and carry the same
    residuals."""
    _fused_run_against_the_train_step("int8_ef")


def _fused_run_against_the_train_step(wire):
    _, params, bn_state = _init()
    images, labels = _data()
    pad, steps = 4, 3
    gen = np.random.default_rng(7)
    order = np.stack([gen.permutation(N)[:BATCH] for _ in range(steps)]).astype(np.int64)
    offsets = gen.integers(0, 2 * pad + 1, (steps, BATCH, 2)).astype(np.int64)

    def fresh():
        model = bridge.load_jax_resnet(resnet.ResNet(**MODEL, device="cpu"), params, bn_state)
        opt = optim.SGD(momentum=0.9, weight_decay=1e-4, fused=True)
        st = state.TrainState.create(model, opt)
        if wire == "int8_ef":
            lay = step.flat_layout(model)
            st.ef, st.layout = step.init_ef_state(model, layout=lay), lay
        return opt, st

    opt, st = fresh()
    runner = epoch.make_fused_epoch(opt, batch_per_device=BATCH, pad=pad,
                                    compute_dtype=torch.float32, grad_compression=wire)
    x, y = torch.from_numpy(images), torch.from_numpy(labels.astype(np.int64))
    st, _ = runner.run(st, x, y, LR, torch.from_numpy(order), torch.from_numpy(offsets))
    fused_losses = runner.step_metrics[:, 0].tolist()

    opt2, st2 = fresh()
    train_step = step.make_train_step(opt2, grad_compression=wire)
    std_inv = (1.0 / CIFAR100_STD).astype(np.float32)
    losses = []
    for i in range(steps):
        padded = np.pad(images[order[i]], ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        crop = np.stack([p[r:r + SIZE, c:c + SIZE] for p, (r, c) in zip(padded, offsets[i])])
        batch = (crop.astype(np.float32) / np.float32(255.0) - CIFAR100_MEAN) * std_inv
        st2, m = train_step(st2, batch, labels[order[i]].astype(np.int64), LR)
        losses.append(m["loss"].item())
    assert fused_losses == losses
    assert st.step == st2.step == steps
    if wire == "int8_ef":
        assert st.ef["r1"].abs().max() > 0  # the residuals were carried
    for a, b in zip(bridge.train_state_to_flat(st).values(),
                    bridge.train_state_to_flat(st2).values()):
        np.testing.assert_array_equal(a, b)


def test_a_dropped_runner_is_freed_without_a_collection():
    """The runners hold no reference cycle, so a dropped runner (and on a
    card its CUDA graph) is freed when its last reference goes, never by a
    garbage collection that could fall inside another runner's capture."""
    _, params, bn_state = _init()
    images, labels = _data()
    model = bridge.load_jax_resnet(resnet.ResNet(**MODEL, device="cpu"), params, bn_state)
    opt = optim.SGD(momentum=0.9, weight_decay=1e-4)
    st = state.TrainState.create(model, opt)
    x, y = torch.from_numpy(images), torch.from_numpy(labels.astype(np.int64))
    collecting = gc.isenabled()
    gc.disable()
    try:
        runner = epoch.make_fused_epoch(opt, batch_per_device=BATCH, pad=4,
                                        compute_dtype=torch.float32)
        st, _ = runner(st, x, y, LR, 0)
        evaluator = epoch.make_fused_eval(batch_per_device=BATCH, compute_dtype=torch.float32)
        evaluator(st, x, y)
        refs = [weakref.ref(runner), weakref.ref(runner._loop),
                weakref.ref(evaluator), weakref.ref(evaluator._loop)]
        del runner, evaluator
        assert [r() for r in refs] == [None] * 4
    finally:
        if collecting:
            gc.enable()


def test_draw_is_a_permutation_and_offsets_in_range():
    runner = epoch.make_fused_epoch(optim.SGD(), batch_per_device=BATCH, pad=4, seed=3)
    order, offsets = runner.draw(0, 60, "cpu", rank=1)
    assert order.shape == (7, BATCH) and offsets.shape == (7, BATCH, 2)
    assert len(set(order.flatten().tolist())) == 7 * BATCH
    assert int(order.min()) >= 0 and int(order.max()) < 60
    assert int(offsets.min()) >= 0 and int(offsets.max()) <= 8
    again, _ = runner.draw(0, 60, "cpu", rank=1)
    assert torch.equal(order, again)
    for other in (runner.draw(1, 60, "cpu", rank=1)[0], runner.draw(0, 60, "cpu", rank=0)[0]):
        assert not torch.equal(order, other)
    assert epoch.fused_steps_per_epoch(50_000, 256) == 195
