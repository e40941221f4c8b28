"""The port's ViT (``tpu_dist_torch.nn.vit``), attention and weight bridge
held against the JAX package's ``ViTDef``.

Weights come from the JAX init and cross through ``tpu_dist_torch.bridge``;
images come from a numpy seed. The JAX side runs its flash attention in
Pallas interpret mode. All in f32: both sides compute the same function
in f32 in another order, so logits agree to a few ulps of their
magnitude (2e-5 absolute for |logits| ~ 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist.nn import attention as jax_attention
from tpu_dist.nn import vit as jax_vit
from tpu_dist_torch import bridge
from tpu_dist_torch.nn import attention as attn
from tpu_dist_torch.nn import vit

LOGITS_TOL = dict(atol=2e-5, rtol=1e-5)


def _jax_params(model_def, seed=0):
    params, _ = model_def.init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("name,expected", [
    ("vit_b16", 86_566_120), ("vit_s16", None), ("vit_tiny", None),
])
def test_param_count_matches_jax(name, expected):
    """Counted on the JAX side from ``eval_shape`` (no full init)."""
    shapes = jax.eval_shape(getattr(jax_vit, name)().init, jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    n_port = sum(p.numel() for p in getattr(vit, name)(device="cpu").parameters())
    assert n_port == n_jax
    if expected is not None:
        assert n_port == expected


@pytest.mark.parametrize("image", (32, 24), ids=("64-tokens", "ragged-36-tokens"))
@pytest.mark.parametrize("impl", ("xla", "flash"))
def test_bridged_vit_tiny_logits_match_jax(impl, image):
    """Image 24 gives 36 tokens of the 64-row position table: the leading
    rows are used, and 36 is not a multiple of any tile."""
    model_def = jax_vit.vit_tiny(image_size=32)
    params = _jax_params(model_def)
    x = _images(2, image)
    j_logits, _ = model_def.apply(
        jax.tree_util.tree_map(jnp.asarray, params), {}, jnp.asarray(x), attn_impl=impl
    )
    model = vit.vit_tiny(image_size=32, attn_impl=impl, device="cpu")
    bridge.load_jax_vit(model, params)
    with torch.inference_mode():
        logits = model(torch.from_numpy(x)).numpy()
    assert logits.shape == (2, 10)
    np.testing.assert_allclose(logits, np.asarray(j_logits), **LOGITS_TOL)


def test_flash_and_xla_paths_agree_in_the_port():
    params = _jax_params(jax_vit.vit_tiny(), seed=1)
    x = torch.from_numpy(_images(3, 32, seed=1))
    out = {}
    for impl in ("xla", "flash"):
        model = vit.vit_tiny(attn_impl=impl, device="cpu")
        bridge.load_jax_vit(model, params)
        with torch.inference_mode():
            out[impl] = model(x).numpy()
    np.testing.assert_allclose(out["flash"], out["xla"], **LOGITS_TOL)


def test_patchify_matches_jax():
    x = _images(2, 8, seed=2)
    np.testing.assert_array_equal(
        vit.patchify(torch.from_numpy(x), 4).numpy(), np.asarray(jax_vit.patchify(jnp.asarray(x), 4))
    )


@pytest.mark.parametrize("causal", (False, True))
def test_full_attention_xla_matches_jax(causal):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 13, 3, 16)).astype(np.float32) for _ in range(3))
    expect = jax_attention.full_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                          causal=causal, impl="xla")
    got = attn.attention(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal, impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-5, rtol=1e-5)


def test_attention_rejects_unknown_impl():
    t = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError):
        attn.attention(t, t, t, impl="ring")
    with pytest.raises(ValueError):
        vit.vit_tiny(attn_impl="ring", device="cpu")


def test_vit_rejects_oversized_images():
    model = vit.vit_tiny(image_size=32, device="cpu")
    with torch.inference_mode(), pytest.raises(ValueError, match="patch tokens"):
        model(torch.zeros(1, 40, 40, 3))


def test_block_matches_jax_block_and_its_traps():
    """One block against ``tp_block_forward`` (no TP) on unit-scale
    activations, where the block's own numerics show: qkv splits as
    [heads, 3, h_dim] and GELU is the tanh form. With exact GELU on the
    port side the outputs move ~50x past the tolerance."""
    params = _jax_params(jax_vit.vit_tiny(), seed=3)
    t = np.random.default_rng(0).standard_normal((2, 64, 64)).astype(np.float32)
    ident = lambda v: v  # noqa: E731
    expect = np.asarray(jax_vit.tp_block_forward(
        jax.tree_util.tree_map(jnp.asarray, params["blocks"][0]), jnp.asarray(t), 16,
        ident, ident))
    model = vit.vit_tiny(device="cpu")
    bridge.load_jax_vit(model, params)
    tol = dict(atol=1e-5, rtol=1e-5)  # f32, |out| ~ 4: a few ulps
    with torch.inference_mode():
        np.testing.assert_allclose(model.blocks[0](torch.from_numpy(t), "xla").numpy(),
                                   expect, **tol)
        gelu = torch.nn.functional.gelu
        try:
            torch.nn.functional.gelu = lambda y, approximate="none": gelu(y)
            exact_gelu = model.blocks[0](torch.from_numpy(t), "xla").numpy()
        finally:
            torch.nn.functional.gelu = gelu
    assert np.abs(exact_gelu - expect).max() > 20 * tol["atol"]


def test_bridge_maps_names_and_transposes():
    params = _jax_params(jax_vit.vit_tiny())
    sd = bridge.vit_state_dict_from_jax(params)
    np.testing.assert_array_equal(sd["blocks.1.qkv.weight"], params["blocks"][1]["qkv"]["w"].T)
    np.testing.assert_array_equal(sd["ln_f.weight"], params["ln_f"]["scale"])
    np.testing.assert_array_equal(sd["pos"], params["pos"])
    assert set(sd) == set(vit.vit_tiny(device="cpu").state_dict())


def test_bridge_rejects_unknown_and_missing_keys():
    params = _jax_params(jax_vit.vit_tiny())
    extra = dict(params, cls=np.zeros((1, 64), np.float32))
    with pytest.raises(KeyError, match="unknown"):
        bridge.vit_state_dict_from_jax(extra)
    missing = dict(params)
    del missing["head"]
    with pytest.raises(KeyError, match="missing"):
        bridge.vit_state_dict_from_jax(missing)
    bad_block = dict(params, blocks=[dict(params["blocks"][0], attn={}), params["blocks"][1]])
    with pytest.raises(KeyError):
        bridge.vit_state_dict_from_jax(bad_block)
    # a depth the module does not have
    shallow = dict(params, blocks=params["blocks"][:1])
    with pytest.raises(KeyError, match="missing"):
        bridge.load_jax_vit(vit.vit_tiny(device="cpu"), shallow)


def test_bridge_rejects_misshapen_weights():
    params = _jax_params(jax_vit.vit_tiny(num_classes=7))
    with pytest.raises(ValueError, match="head.weight"):
        bridge.load_jax_vit(vit.vit_tiny(num_classes=10, device="cpu"), params)


def test_numpy_params_have_the_jax_layout():
    model = vit.vit_tiny(device="cpu")
    ours = bridge.numpy_vit_params(model, seed=0)
    theirs = jax.eval_shape(jax_vit.vit_tiny().init, jax.random.PRNGKey(0))[0]
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda s: 0, theirs))
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert a.shape == b.shape and a.dtype == np.float32
    again = bridge.numpy_vit_params(model, seed=0)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_vit_seeded_init_is_deterministic():
    a = vit.vit_tiny(device="cpu", seed=5).state_dict()
    b = vit.vit_tiny(device="cpu", seed=5).state_dict()
    c = vit.vit_tiny(device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pos"], c["pos"])


def test_model_without_gpu_needs_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vit.vit_tiny()
