"""The port's ResNets (``tpu_dist_torch.nn.resnet``) and their bridge
(``tpu_dist_torch.bridge.resnet_*``) held against the JAX package's
``ResNetDef``: parameter and BN-statistic counts, bridged logits and new
BN state in train and eval mode (f32, one process), and the bridge both
ways, bit for bit."""

import functools

import jax
import numpy as np
import pytest
import torch
import torch_ranks  # noqa: F401  (one torch thread in this process)
from test_models import GOLDEN

from tpu_dist.nn import resnet as jax_resnet
from tpu_dist_torch import bridge
from tpu_dist_torch.nn import resnet

NARROW = (8, 16, 32, 64)


@pytest.mark.parametrize("factory,n_params,n_stats", GOLDEN,
                         ids=[f.__name__ for f, _, _ in GOLDEN])
def test_param_and_bn_stat_counts_match_the_goldens(factory, n_params, n_stats):
    model = getattr(resnet, factory.__name__)(device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_params
    assert sum(b.numel() for b in model.buffers()) == n_stats


def test_resnet18_has_62_leaves_and_the_imagenet_resnet50_its_count():
    assert len(list(resnet.resnet18(device="meta").parameters())) == 62
    jax_n = sum(x.size for x in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jax_resnet.resnet50_imagenet().init(jax.random.PRNGKey(0))[0])))
    assert sum(p.numel() for p in resnet.resnet50_imagenet(device="meta").parameters()) == jax_n


def test_s2d_stem_is_refused():
    with pytest.raises(NotImplementedError, match="s2d_stem"):
        resnet.resnet50_imagenet(s2d_stem=True, device="meta")


@functools.lru_cache(maxsize=None)
def _weights(block, stage_blocks, imagenet_stem, seed):
    """JAX-layout numpy weights: the port's seeded initial weights through
    the bridge, with running statistics moved away from their (0, 1)
    start so eval mode reads them. (The layout is held against JAX's own
    ``init`` by ``test_bridged_layout_is_jax_init_layout``.)"""
    model = resnet.ResNet(block, stage_blocks, 10, widths=NARROW,
                          imagenet_stem=imagenet_stem, device="cpu", seed=seed)
    params, state = bridge.resnet_params_to_jax(model)
    rng = np.random.default_rng(seed)
    state = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), state)
    return params, state


def _pair(block, stage_blocks, imagenet_stem=False, seed=0):
    md = jax_resnet.ResNetDef(block, stage_blocks, 10, widths=NARROW, imagenet_stem=imagenet_stem)
    params, state = _weights(block, stage_blocks, imagenet_stem, seed)
    model = resnet.ResNet(block, stage_blocks, 10, widths=NARROW,
                          imagenet_stem=imagenet_stem, device="cpu")
    bridge.load_jax_resnet(model, params, state)
    return md, params, state, model


MODELS = {
    "resnet18 narrow": ("basic", (2, 2, 2, 2), False),
    "resnet50 narrow, ImageNet stem": ("bottleneck", (1, 1, 1, 1), True),
}

# f32 on both sides: the same convolutions summed in another order (XLA's
# vs PyTorch's CPU kernels), and in training BN divides by batch
# statistics of ~1e-1: logits of size ~1 agree to ~1e-5, and the running
# statistics (sizes ~1) to a few ulps.
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(MODELS))
def test_bridged_layout_is_jax_init_layout(name):
    md, params, state, _ = _pair(*MODELS[name])
    want = jax.eval_shape(md.init, jax.random.PRNGKey(0))
    for got, ref in zip((params, state), want):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
        assert [a.shape for a in jax.tree_util.tree_leaves(got)] == [
            r.shape for r in jax.tree_util.tree_leaves(ref)]


@pytest.mark.parametrize("train", (True, False), ids=("train", "eval"))
@pytest.mark.parametrize("name", list(MODELS))
def test_bridged_logits_and_bn_state_match_jax(name, train):
    md, params, state, model = _pair(*MODELS[name])
    x = np.random.default_rng(1).standard_normal((4, 32, 32, 3)).astype(np.float32)
    want_logits, want_state = jax.jit(functools.partial(md.apply, train=train))(params, state, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_logits), **LOGIT_TOL)
    _, got_state = bridge.resnet_params_to_jax(model)
    assert jax.tree_util.tree_structure(got_state) == jax.tree_util.tree_structure(want_state)
    for a, b in zip(jax.tree_util.tree_leaves(got_state), jax.tree_util.tree_leaves(want_state)):
        np.testing.assert_allclose(a, np.asarray(b), **STAT_TOL)
    if not train:  # eval leaves the running statistics as they were
        for a, b in zip(jax.tree_util.tree_leaves(got_state), jax.tree_util.tree_leaves(state)):
            np.testing.assert_array_equal(a, b)


def test_model_input_is_nhwc_and_stays_channels_last():
    _, _, _, model = _pair("basic", (1, 1, 1, 1))
    seen = []
    model.stem_bn.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    model(torch.zeros(2, 32, 32, 3), train=False)
    assert seen[0].shape == (2, 8, 32, 32)
    assert seen[0].is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_round_trips_bit_for_bit(name):
    _, params, state, model = _pair(*MODELS[name], seed=3)
    back_params, back_state = bridge.resnet_params_to_jax(model)
    for back, orig in ((back_params, params), (back_state, state)):
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(orig)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(orig)):
            np.testing.assert_array_equal(a, b)
    # the momentum pytree mirrors the parameters, in the model's order
    mom = jax.tree_util.tree_map(lambda a: a * 0.5 + 1.0, params)
    bufs = bridge.resnet_sgd_state_from_jax(model, mom)
    assert [b.shape for b in bufs] == [p.shape for p in model.parameters()]
    for a, b in zip(jax.tree_util.tree_leaves(bridge.resnet_sgd_state_to_jax(model, bufs)),
                    jax.tree_util.tree_leaves(mom)):
        np.testing.assert_array_equal(a, b)


def test_bridge_rejects_bad_keys():
    _, params, state, model = _pair("basic", (1, 1, 1, 1))
    with pytest.raises(KeyError, match="unknown"):
        bridge.resnet_state_dict_from_jax(dict(params, head={}), state)
    with pytest.raises(KeyError, match="BN"):
        bridge.resnet_state_dict_from_jax(
            params, dict(state, stage1=[{"bn1": state["stage1"][0]["bn1"]}]))
    sd = {n: t.numpy() for n, t in model.state_dict().items()}
    with pytest.raises(KeyError, match="unknown"):
        bridge.resnet_state_dict_to_jax(dict(sd, **{"stage1.0.extra.weight": np.zeros(1)}))
    with pytest.raises(ValueError, match="fc.weight"):
        bridge.load_jax_resnet(resnet.ResNet("basic", (1, 1, 1, 1), 7, widths=NARROW,
                                             device="cpu"), params, state)


def test_f32_gradients_on_cropped_inputs_match_f64():
    """The trainer's inputs: random 32x32 crops of zero-padded images,
    normalized. The port's f32 gradients agree with its own f64 evaluation
    to ~1e-6 relative L2 per leaf (f32 summation order). The JAX step's f32
    gradients on such inputs are off from f64 by up to ~1% on the CPU
    (ROADMAP Queue C); the port is held to the f64 values, and to JAX's
    within that 1% (2e-2 relative L2)."""
    import jax.numpy as jnp  # noqa: PLC0415

    from tpu_dist.nn import functional as jax_F  # noqa: PLC0415
    from tpu_dist_torch.data import transforms  # noqa: PLC0415
    from tpu_dist_torch.nn import functional as F  # noqa: PLC0415

    md, params, state, _ = _pair("basic", (1, 1, 1, 1))
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    x = transforms.gather_augment(images, np.arange(16), seed=1, train=True)
    y = rng.integers(0, 10, 16).astype(np.int32)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = resnet.ResNet("basic", (1, 1, 1, 1), 10, widths=NARROW, device="cpu")
        bridge.load_jax_resnet(model, params, state)
        model = model.to(dtype)
        loss = F.cross_entropy(model(torch.from_numpy(x).to(dtype), train=True),
                               torch.from_numpy(y))
        g = torch.autograd.grad(loss, list(model.parameters()))
        grads[dtype] = bridge.resnet_sgd_state_to_jax(model, [t.double() for t in g])

    def jax_loss(p):
        return jax_F.cross_entropy(md.apply(p, state, jnp.asarray(x), train=True)[0], y)

    jax_grads = jax.jit(jax.grad(jax_loss))(params)
    for ours, exact, theirs in zip(*(jax.tree_util.tree_leaves(t) for t in (
            grads[torch.float32], grads[torch.float64], jax_grads))):
        exact = np.asarray(exact, np.float64)
        assert np.linalg.norm(ours - exact) <= 1e-5 * np.linalg.norm(exact)
        assert np.linalg.norm(ours - np.asarray(theirs)) <= 2e-2 * np.linalg.norm(exact)


def test_bridge_copies_the_weights_it_converts():
    """The converted pytree is a snapshot: training the model afterwards
    leaves it as it was (an f32 CPU tensor's ``.numpy()`` alone would share
    memory with the live weight)."""
    _, _, _, model = _pair("basic", (1, 1, 1, 1))
    params, state = bridge.resnet_params_to_jax(model)
    before = [a.copy() for a in jax.tree_util.tree_leaves((params, state))]
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.add_(1.0)
    for a, b in zip(jax.tree_util.tree_leaves((params, state)), before):
        np.testing.assert_array_equal(a, b)
