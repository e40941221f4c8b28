"""The port's int8 quantization (``tpu_dist_torch/comm/quantize.py``) and
int8 serving weights (``serve/engine.py``: ``quantize_weights``,
``dequantize_weights``, ``Int8Weights``) held against the JAX package's.

Everything here must agree bit for bit: both sides take the same f32
inputs through the same IEEE operations in the same order (max, divide
by 127, reciprocal, product, round half to even, clip), so there is no
tolerance anywhere in this file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ranks import narrow_resnet

from tpu_dist.comm import quantize as jax_q
from tpu_dist.nn import vit as jax_vit
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.serve import engine as jax_engine
from tpu_dist_torch import bridge
from tpu_dist_torch.comm import quantize
from tpu_dist_torch.nn import vit
from tpu_dist_torch.serve import engine
from tpu_dist_torch.train.step import NotPortedError


def _bits(a) -> np.ndarray:
    """An array's bytes as unsigned integers: equality of these is
    equality bit for bit (signed zeros and NaN payloads included)."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def _assert_same(ours: torch.Tensor, theirs) -> None:
    theirs = np.asarray(theirs)
    assert ours.dtype == {np.dtype(np.int8): torch.int8,
                          np.dtype(np.float32): torch.float32}[theirs.dtype]
    assert tuple(ours.shape) == theirs.shape
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(theirs))


@pytest.mark.parametrize("length", [0, 1, 7, 8, 9, 255, 256, 257, 1000])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_padded_len_matches_jax(length, n):
    assert quantize.padded_len(length, n) == jax_q.padded_len(length, n)


def _case(name: str, m: int, chunk: int, rng) -> np.ndarray:
    x = rng.standard_normal(m).astype(np.float32)
    if name == "zero_chunks":  # every other chunk all zero: scale 0, q 0
        for start in range(0, m, 2 * chunk):
            x[start:start + chunk] = 0.0
    elif name == "ties":
        # a chunk whose max is 127 has scale 1 and reciprocal 1 exactly, so
        # every x.5 lands on a tie: half to even (0.5 -> 0, 1.5 -> 2, -2.5 -> -2)
        ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5],
                        np.float32)
        x = np.resize(ties, m)
        x[::chunk] = 127.0
    elif name == "extremes":  # +-max of each chunk maps to +-127 exactly
        x[::chunk] = np.abs(x[::chunk]) * 3.0
        x[1::chunk] = -np.abs(x[::chunk][: len(x[1::chunk])])
    elif name == "tiny_and_huge":
        x = x * np.float32(10.0) ** rng.integers(-30, 30, m).astype(np.float32)
    return x


CASES = ("normal", "zero_chunks", "ties", "extremes", "tiny_and_huge")


@pytest.mark.parametrize("chunk", [1, 7, 256])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("m", [1, 6, 256, 1000])  # 1000: a ragged tail at 7 and 256
def test_quantize_int8_matches_jax_bit_for_bit(name, m, chunk):
    x = _case(name, m, chunk, np.random.default_rng(m * 31 + chunk))
    q, s = quantize.quantize_int8(torch.from_numpy(x), chunk=chunk)
    jq, js = jax_q.quantize_int8(jnp.asarray(x), chunk=chunk)
    _assert_same(q, jq)
    _assert_same(s, js)
    back = quantize.dequantize_int8(q, s, chunk=chunk)
    _assert_same(back, jax_q.dequantize_int8(jq, js, chunk=chunk))


def test_ties_round_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5])
    q, s = quantize.quantize_int8(x, chunk=8)
    assert s.tolist() == [1.0]
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


def test_rows_quantize_independently_like_jax():
    """A ``(rows, m)`` input: chunks run along the last axis of each row."""
    x = np.random.default_rng(5).standard_normal((3, 300)).astype(np.float32)
    x[1] = 0.0
    q, s = quantize.quantize_int8(torch.from_numpy(x), chunk=64)
    jq, js = jax_q.quantize_int8(jnp.asarray(x), chunk=64)
    _assert_same(q, jq)
    _assert_same(s, js)
    assert s.shape == (3, 5)


def test_stochastic_rounding_is_refused():
    with pytest.raises(NotPortedError, match="Queue A 6"):
        quantize.quantize_int8(torch.ones(8), key=0)


# -- int8 serving weights, per leaf, in the JAX layout -------------------------


def _resnet_pair():
    port = narrow_resnet(10, "cpu", 3)
    params, bn = bridge.resnet_params_to_jax(port)
    return port, params, bn


def _vit_pair():
    port = vit.vit_tiny(device="cpu", seed=2)
    return port, bridge.vit_params_to_jax(port), {}


PAIRS = {"resnet": _resnet_pair, "vit": _vit_pair}


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_quantize_weights_matches_jax_for_every_leaf(kind):
    _, params, _ = PAIRS[kind]()
    ours, our_shapes = engine.quantize_weights(params)
    theirs, their_shapes = jax_engine.quantize_weights(params)
    flat_ours, flat_theirs = bridge.keystr_leaves(ours), bridge.keystr_leaves(theirs)
    assert list(flat_ours) == list(flat_theirs) and flat_ours
    for key in flat_theirs:
        _assert_same(flat_ours[key], flat_theirs[key])
    assert our_shapes == their_shapes
    back = bridge.keystr_leaves(engine.dequantize_weights(ours, our_shapes))
    back_jax = bridge.keystr_leaves(jax_engine.dequantize_weights(theirs, their_shapes))
    for key in back_jax:
        _assert_same(back[key], back_jax[key])


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_int8_weights_of_the_module_match_jax_for_every_leaf(kind):
    """The engine's flat buffers, read leaf by leaf, hold JAX's ``q`` and
    ``scale`` of the same parameter in the JAX layout, and one dequantize
    gives JAX's dequantized weights in the module's layout."""
    port, params, _ = PAIRS[kind]()
    int8 = engine.Int8Weights(port, "cpu")
    theirs, shapes = jax_engine.quantize_weights(params)
    sd_names = {name for name, _ in port.named_parameters()}
    # the JAX leaf of each parameter, through the bridge's name mapping
    q_by_name = _by_param_name(port, bridge.keystr_leaves(theirs))
    assert set(q_by_name) == sd_names
    for name in sd_names:
        q, s = int8.leaf(name)
        _assert_same(q, q_by_name[name]["q"])
        _assert_same(s, q_by_name[name]["scale"])
    deq = jax.tree_util.tree_map(np.asarray, jax_engine.dequantize_weights(theirs, shapes))
    want = (bridge.resnet_state_dict_from_jax(deq) if kind == "resnet"
            else bridge.vit_state_dict_from_jax(deq))
    got = int8.dequantize()
    assert set(got) == sd_names
    for name in sd_names:
        _assert_same(got[name].contiguous(), np.ascontiguousarray(want[name]))
    n_chunks = sum(-(-p.numel() // 256) for p in port.parameters())
    assert int8.nbytes == n_chunks * 256 + 4 * n_chunks


def _by_param_name(port, flat_q: dict) -> dict:
    """``{parameter name: {"q", "scale"}}``: each JAX leaf's quantized pair
    under the port's parameter name. The bridge maps the names: a state
    dict whose every entry is filled with its own index comes out of the
    converter with each JAX leaf holding the index of its parameter."""
    named = list(port.named_parameters())
    marked = {n: np.full(tuple(p.shape), i, np.float32) for i, (n, p) in enumerate(named)}
    tree = (bridge.vit_state_dict_to_jax(marked) if isinstance(port, vit.ViT)
            else bridge.resnet_state_dict_to_jax(marked)[0])
    out = {}
    for key, leaf in bridge.keystr_leaves(tree).items():
        name = named[int(np.asarray(leaf).flat[0])][0]
        out[name] = {"q": flat_q[key + "['q']"], "scale": flat_q[key + "['scale']"]}
    return out


def test_int8_weights_cost_a_quarter_of_f32():
    port = vit.vit_tiny(device="cpu")
    f32 = 4 * sum(p.numel() for p in port.parameters())
    int8 = engine.Int8Weights(port, "cpu")
    assert int8.nbytes < 0.27 * f32  # 1 byte an element + 4 bytes a 256 + padding


def test_narrow_models_are_the_jax_ones():
    """The JAX twins of the models above have the same leaves (the pair
    functions bridge the port's weights, so a missing leaf would show)."""
    jax_params, _ = ResNetDef("basic", (1, 1, 1, 1), 10, widths=(8, 16, 32, 64)).init(
        jax.random.PRNGKey(0))
    _, params, _ = _resnet_pair()
    assert list(bridge.keystr_leaves(jax.tree_util.tree_map(np.asarray, jax_params))) == list(
        bridge.keystr_leaves(params))
    jax_vit_params, _ = jax_vit.vit_tiny().init(jax.random.PRNGKey(0))
    _, vparams, _ = _vit_pair()
    assert list(bridge.keystr_leaves(jax.tree_util.tree_map(np.asarray, jax_vit_params))) == list(
        bridge.keystr_leaves(vparams))
