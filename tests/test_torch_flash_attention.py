"""The port's flash-attention forward (``tpu_dist_torch.ops.flash_attention``)
held against the JAX package's Pallas forward, run in interpret mode (the
backward is in ``test_torch_flash_attention_bwd.py``).

On the CPU the port's wrapper takes its plain version
(``flash_fwd_reference``); the CUDA kernel itself is checked against the
same plain version on the card by ``chip_smoke.py``. Inputs come from a
numpy seed and go to both sides as the same arrays.
"""

import functools
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist.ops import flash_attention as jax_fa
from tpu_dist_torch.ops import flash_attention as fa

H = 3  # heads; batch 1, so BH = 3

# f32: both sides accumulate in f32, in another order (the Pallas kernel's
# online softmax over 128-key tiles vs one softmax over the row): a few ulps.
# bf16: the inputs are the same bf16 values and both compute in f32, but
# each rounds its own f32 output to bf16, so the two may sit one bf16 step
# apart (2^-8 relative; 1e-2 covers it for |out| < 2); m and l stay f32.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1e-2)}
TOL_STATS = dict(atol=1e-5, rtol=1e-5)

CASES = [
    (causal, s, d, dtype)
    for causal in (False, True)
    for s in (64, 77)
    for d in (16, 64)
    for dtype in ("float32", "bfloat16")
]


def _ids(case):
    causal, s, d, dtype = case
    return f"{'causal' if causal else 'full'}-S{s}-D{d}-{dtype}"


@functools.lru_cache(maxsize=None)
def _case(causal, s, d, dtype):
    """Inputs [1, S, H, D] as f32 numpy (bf16-representable for bf16) and
    the JAX ``_fwd`` results on their [BH, S, D] view, one interpret-mode
    call per case shared by the tests below."""
    rng = np.random.default_rng(1000 * s + d + int(causal))
    q4, k4, v4 = (rng.standard_normal((1, s, H, d)).astype(np.float32) for _ in range(3))
    if dtype == "bfloat16":
        q4, k4, v4 = (np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32) for t in (q4, k4, v4))
    to3 = lambda t: np.ascontiguousarray(t.transpose(0, 2, 1, 3).reshape(H, s, d))  # noqa: E731
    q3, k3, v3 = (jnp.asarray(to3(t), dtype) for t in (q4, k4, v4))
    out, m, l = jax_fa._fwd(q3, k3, v3, causal, 128, 128, True)
    return (q4, k4, v4), tuple(np.asarray(t, np.float32) for t in (out, m, l))


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_fwd_reference_matches_jax_fwd(case):
    causal, s, d, dtype = case
    (q4, k4, v4), (j_out, j_m, j_l) = _case(*case)
    q3, k3, v3 = (
        _torch(t.transpose(0, 2, 1, 3).reshape(H, s, d), dtype) for t in (q4, k4, v4)
    )
    out, m, l = fa.flash_fwd_reference(q3, k3, v3, causal)
    assert out.dtype == getattr(torch, dtype) and m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), j_out, **TOL[dtype])
    np.testing.assert_allclose(m.numpy(), j_m, **TOL_STATS)
    np.testing.assert_allclose(l.numpy(), j_l, **TOL_STATS)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_attention_bshd_matches_jax(case):
    """The [B, S, H, D] entry point on the CPU (the plain path) against the
    JAX forward's output laid back out as [B, S, H, D]."""
    causal, s, d, dtype = case
    (q4, k4, v4), (j_out, _, _) = _case(*case)
    before = fa.flash_fwd.launches
    with torch.inference_mode():
        out = fa.flash_attention(*(_torch(t, dtype) for t in (q4, k4, v4)), causal=causal)
    assert fa.flash_fwd.launches == before  # the CPU path launches no kernel
    assert out.shape == (1, s, H, d) and out.dtype == getattr(torch, dtype)
    expect = j_out.reshape(1, H, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.float().numpy(), expect, **TOL[dtype])


@pytest.mark.parametrize("causal", (False, True))
def test_flash_fwd_on_cpu_is_the_plain_version(causal):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 32)).astype(np.float32))
               for _ in range(3))
    got = fa.flash_fwd(q, k, v, causal)
    ref = fa.flash_fwd_reference(q, k, v, causal)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_out_dtype_override():
    """The ring composition's f32 output for bf16 inputs."""
    q, k, v = (torch.ones(2, 8, 16, dtype=torch.bfloat16) for _ in range(3))
    out, m, l = fa.flash_fwd(q, k, v, False, torch.float32)
    assert out.dtype == torch.float32 and m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), 1.0)
    np.testing.assert_allclose(l.numpy(), 8.0)  # eight equal scores: exp(0) each


def test_first_causal_row_sees_only_itself():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 9, 16)).astype(np.float32))
               for _ in range(3))
    out, m, l = fa.flash_fwd(q, k, v, True)
    np.testing.assert_allclose(out[0, 0].numpy(), v[0, 0].numpy(), rtol=1e-6)
    assert l[0, 0].item() == 1.0
    np.testing.assert_allclose(m[0, 0].item(), (q[0, 0] @ k[0, 0]).item() / 4.0, rtol=1e-6)


def test_grad_requiring_tensor_raises():
    """The kernel wrapper is not differentiable (a CUDA result would come
    back silently detached), so with grad enabled it refuses; the
    differentiable entry point is ``flash_attention``, and under no_grad
    the wrapper runs."""
    q = torch.zeros(1, 8, 16, requires_grad=True)
    k = v = torch.zeros(1, 8, 16)
    with pytest.raises(RuntimeError, match="not differentiable"):
        fa.flash_fwd(q, k, v)
    with torch.no_grad():
        fa.flash_fwd(q, k, v)
    out = fa.flash_attention(q.reshape(1, 8, 1, 16), k.reshape(1, 8, 1, 16),
                             v.reshape(1, 8, 1, 16))
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape


@pytest.mark.parametrize("d", (8, 48, 256))
def test_bad_head_dim_raises(d):
    t = torch.zeros(1, 8, d)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(t, t, t)


@pytest.mark.parametrize("dtype", (torch.float16, torch.float64, torch.int32))
def test_bad_dtype_raises(dtype):
    t = torch.zeros(1, 8, 16, dtype=dtype)
    with pytest.raises(TypeError):
        fa.flash_fwd(t, t, t)


def test_mixed_dtypes_and_shapes_raise():
    a = torch.zeros(1, 8, 16)
    with pytest.raises(TypeError):
        fa.flash_fwd(a, a.bfloat16(), a)
    with pytest.raises(ValueError):
        fa.flash_fwd(a, torch.zeros(1, 9, 16), a)
    with pytest.raises(TypeError):
        fa.flash_fwd(a, a, a, False, torch.float16)


def test_non_contiguous_inputs_raise():
    t = torch.zeros(1, 16, 8).transpose(1, 2)  # [1, 8, 16], strided
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(t, t, t)


@pytest.mark.parametrize("b", (1, 2))
def test_flash_attention_takes_strided_qkv_slices(b):
    """The model hands it q, k, v sliced out of one [b, s, h, 3, d] tensor;
    with b == 1 a plain reshape would keep a strided view."""
    qkv = torch.from_numpy(
        np.random.default_rng(b).standard_normal((b, 10, 2, 3, 16)).astype(np.float32))
    q, k, v = (qkv[:, :, :, i, :] for i in range(3))
    out = fa.flash_attention(q, k, v)
    ref, _, _ = fa.flash_fwd_reference(
        *(t.permute(0, 2, 1, 3).reshape(b * 2, 10, 16) for t in (q, k, v)))
    torch.testing.assert_close(out, ref.reshape(b, 2, 10, 16).permute(0, 2, 1, 3))


def test_meta_tensors_are_refused():
    t = torch.zeros(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(t, t, t)


# -- the two routes on the card: bf16 on the tensor cores, f32 on the CUDA cores

CSRC = pathlib.Path(fa.__file__).resolve().parent.parent / "csrc"


def _direct_f32_fwd(q, k, v, causal):
    """The f32 forward written out once more, op for op as before the
    tensor-core route existed: the f32 plain version must stay this, bit
    for bit."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    mask = torch.ones(s.shape[-2:], dtype=torch.bool)
    if causal:
        mask = torch.arange(s.shape[-2])[:, None] >= torch.arange(s.shape[-1])[None, :]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    return torch.matmul(p, v) / torch.clamp(l, min=1e-30)[..., None], m, l


@pytest.mark.parametrize("causal", (False, True))
def test_f32_plain_forward_is_unchanged_bit_for_bit(causal):
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 77, 32)).astype(np.float32))
               for _ in range(3))
    for got, want in zip(fa.flash_fwd_reference(q, k, v, causal), _direct_f32_fwd(q, k, v, causal)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("causal", (False, True))
def test_bf16_plain_forward_rounds_p_before_pv_only(causal):
    """bf16 inputs: P enters P V as bf16 (the tensor cores' operand), while
    m, l and the division stay f32 and l sums the unrounded P."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 77, 32)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    out, m, l = fa.flash_fwd_reference(q, k, v, causal, torch.float32)
    f_out, f_m, f_l = _direct_f32_fwd(*(t.float() for t in (q, k, v)), causal)
    assert torch.equal(m, f_m) and torch.equal(l, f_l)
    scale = 1.0 / math.sqrt(32)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = torch.ones(77, 77, dtype=torch.bool)
    if causal:
        mask = torch.arange(77)[:, None] >= torch.arange(77)[None, :]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.where(mask, torch.exp(s - f_m[..., None]), torch.zeros_like(s))
    pv = torch.matmul(p.to(torch.bfloat16).float(), v.float())
    want = pv / torch.clamp(f_l, min=1e-30)[..., None]
    assert torch.equal(out, want)
    assert not torch.equal(out, f_out)  # the rounding is there, and it is small:
    # one bf16 step (2^-8 relative) of each P element, of random sign
    torch.testing.assert_close(out, f_out, atol=4e-3, rtol=0)


def test_route_rule_is_by_input_dtype():
    assert fa.uses_tensor_cores(torch.bfloat16)
    assert not fa.uses_tensor_cores(torch.float32)


def test_route_rule_matches_the_c_dispatch():
    """The wrappers count a launch as a tensor-core one by the rule the C
    dispatch applies: ``tensor_core_route`` of the shared header is true for
    the dtype code of bf16 alone, and every flash kernel's C entry point
    branches on it."""
    header = (CSRC / "flash_attention_mma.cuh").read_text()
    codes = dict(re.findall(r"constexpr int DTYPE_(F32|BF16) = (\d+);", header))
    assert {"F32": "0", "BF16": "1"} == codes
    assert codes["BF16"] == str(fa._DTYPE_CODES[torch.bfloat16])
    assert codes["F32"] == str(fa._DTYPE_CODES[torch.float32])
    rule = re.search(r"bool tensor_core_route\(int in_dtype\) \{\s*return ([^;]+);", header)
    assert rule.group(1).strip() == "in_dtype == DTYPE_BF16"
    for source in ("flash_attention_fwd.cu", "flash_attention_bwd_dkdv.cu",
                   "flash_attention_bwd_dq.cu"):
        entry = (CSRC / source).read_text().split('extern "C"')[1]
        assert "tensor_core_route(in_dtype)" in entry, source


def test_misaligned_base_pointer_is_refused():
    """cp.async moves 16 bytes: a view starting 2 bytes into a bf16 buffer
    is refused; a fresh tensor passes."""
    flat = torch.zeros(8 * 16 + 8, dtype=torch.bfloat16)
    fa._check_aligned("flash_fwd", flat[:128].view(1, 8, 16))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_aligned("flash_fwd", flat[1:129].view(1, 8, 16))


def test_launch_counts_split_by_route():
    def wrapper():
        pass

    wrapper.launches = wrapper.launches_mma = 0
    for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
        fa._count_launch(wrapper, dtype)
    assert (wrapper.launches, wrapper.launches_mma) == (3, 2)
    assert all(w.launches_mma >= 0 for w in (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq))
