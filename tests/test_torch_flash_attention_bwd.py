"""The port's flash-attention backward (``tpu_dist_torch.ops.flash_attention``:
``flash_bwd``, its two kernel wrappers and the autograd function) held
against the JAX package's Pallas backward (``_bwd_pallas``) and
``jax.grad`` of its ``flash_attention``, run in interpret mode.

On the CPU the wrappers take their plain versions (``*_reference``); the
CUDA kernels are checked against the same plain versions on the card by
``chip_smoke.py``. Inputs come from a numpy seed and go to both sides as
the same arrays; ``m`` and ``l`` come from the JAX forward.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist.ops import flash_attention as jax_fa
from tpu_dist_torch import bridge
from tpu_dist_torch.nn import vit
from tpu_dist_torch.ops import flash_attention as fa

H = 3  # heads; batch 1, so BH = 3

# f32: both sides accumulate the same products in f32 in another order (the
# Pallas kernels over 128-row tiles, the plain version over whole rows with
# one matmul each), and dS = P (dP - delta) subtracts two O(sqrt(D)) terms,
# so the gradients (|g| up to ~4 here) agree to a few ulps of that size.
# bf16: the same bf16 inputs, f32 arithmetic on both sides, but each rounds
# its own f32 gradient to bf16, so the two may sit one bf16 step apart
# (2^-8 relative; 1e-2 covers it for |g| < 4).
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1e-2)}

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


def _bf16_round(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


@functools.lru_cache(maxsize=None)
def _case(causal, s, d, dtype):
    """[BH, S, D] q, k, v, do as f32 numpy (bf16-representable for bf16),
    the JAX forward's (out, m, l) and the JAX Pallas backward's (dq, dk, dv),
    one interpret-mode call each per case."""
    rng = np.random.default_rng(2000 * s + d + int(causal))
    q, k, v, do = (rng.standard_normal((H, s, d)).astype(np.float32) for _ in range(4))
    if dtype == "bfloat16":
        q, k, v, do = (_bf16_round(t) for t in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(t, dtype) for t in (q, k, v, do))
    out, m, l = jax_fa._fwd(jq, jk, jv, causal, 128, 128, True)
    grads = jax_fa._bwd_pallas(jq, jk, jv, out, m, l, jdo, causal, 128, 128, True)
    f32 = lambda t: np.asarray(t, np.float32)  # noqa: E731
    return (q, k, v, do), (f32(out), f32(m), f32(l)), tuple(f32(g) for g in grads)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_bwd_reference_matches_jax_bwd_pallas(case):
    causal, s, d, dtype = case
    (q, k, v, do), (out, m, l), expect = _case(*case)
    got = fa.flash_bwd_reference(_t(q, dtype), _t(k, dtype), _t(v, dtype), _t(out, dtype),
                                 _t(m), _t(l), _t(do, dtype), causal)
    for name, g, e in zip(("dq", "dk", "dv"), got, expect):
        assert g.dtype == getattr(torch, dtype) and g.shape == (H, s, d), name
        np.testing.assert_allclose(g.float().numpy(), e, **TOL[dtype], err_msg=name)


@pytest.mark.parametrize("causal", (False, True))
def test_flash_bwd_on_cpu_is_the_plain_version(causal):
    """The dispatching wrappers run the plain parts on the CPU, launch no
    kernel, and give what the whole plain backward gives."""
    (q, k, v, do), (out, m, l), _ = _case(causal, 77, 16, "float32")
    args = [_t(a) for a in (q, k, v, out, m, l, do)]
    before = (fa.flash_bwd_dkdv.launches, fa.flash_bwd_dq.launches)
    got = fa.flash_bwd(*args, causal)
    assert (fa.flash_bwd_dkdv.launches, fa.flash_bwd_dq.launches) == before
    for a, b in zip(got, fa.flash_bwd_reference(*args, causal)):
        assert torch.equal(a, b)


def test_delta_passed_in_equals_delta_computed():
    """The ring backward hoists delta = rowsum(do * o) out of its loop."""
    (q, k, v, do), (out, m, l), _ = _case(True, 77, 64, "float32")
    args = [_t(a) for a in (q, k, v, out, m, l, do)]
    delta = (args[6] * args[3]).sum(-1)
    for a, b in zip(fa.flash_bwd(*args, True), fa.flash_bwd(*args, True, delta=delta)):
        assert torch.equal(a, b)
    dk, dv = fa.flash_bwd_dkdv(*args[:3], args[6], args[4], args[5], delta, True)
    dq = fa.flash_bwd_dq(*args[:3], args[6], args[4], args[5], delta, True)
    for a, b in zip((dq, dk, dv), fa.flash_bwd_reference(*args, True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", (False, True))
def test_grad_dtype_f32_on_bf16_input_matches_jax(causal):
    """The ring backward's f32 partials for bf16 inputs: no bf16 rounding of
    the gradients, so the f32 tolerance holds. dQ, dK and dV take P and dS
    as bf16, as the tensor cores do, so they are held against the JAX
    package's own P and dS (``_recompute_p_ds`` over whole rows) rounded
    the same way, with the three products in f32."""
    (q, k, v, do), _, _ = _case(causal, 64, 16, "bfloat16")
    jq, jk, jv, jdo = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, do))
    out, m, l = jax_fa._fwd(jq, jk, jv, causal, 128, 128, True)
    delta = jnp.sum(jdo.astype(jnp.float32) * out.astype(jnp.float32), axis=-1)
    rows = lambda t: t[None]  # noqa: E731 - one bh as a [1, S, D] block
    expect_dq, expect_dk, expect_dv = [], [], []
    for b in range(H):
        qb, dob, p, ds = jax_fa._recompute_p_ds(
            rows(jq[b]), rows(jk[b]), rows(jv[b]), rows(jdo[b]), m[b][None], l[b][None],
            delta[b][None], 0, 0, scale=1.0 / np.sqrt(16), causal=causal, block_q=64,
            block_k=64, q_len=64, kv_len=64)
        r = lambda t: t.astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
        expect_dq.append(np.asarray(r(ds) @ jk[b].astype(jnp.float32)))
        expect_dk.append(np.asarray(r(ds).T @ qb))
        expect_dv.append(np.asarray(r(p).T @ dob))
    got = fa.flash_bwd(*(_t(a, "bfloat16") for a in (q, k, v)),
                       _t(np.asarray(out, np.float32), "bfloat16"),
                       _t(np.asarray(m)), _t(np.asarray(l)), _t(do, "bfloat16"), causal,
                       grad_dtype=torch.float32)
    for g, e in zip(got, (np.stack(expect_dq), np.stack(expect_dk), np.stack(expect_dv))):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **TOL["float32"])


def test_strided_do_reaches_the_kernel_layout(monkeypatch):
    """Autograd hands the backward a strided ``do`` (a permute/reshape
    view): ``flash_bwd`` copies it to the kernels' layout before either
    pass sees it, and the result is the contiguous one's."""
    (q, k, v, do), (out, m, l), _ = _case(False, 64, 16, "float32")
    args = [_t(a) for a in (q, k, v, out, m, l)]
    strided = _t(do).transpose(1, 2).contiguous().transpose(1, 2)   # same values, strided
    assert not strided.is_contiguous()
    seen = []
    for name in ("flash_bwd_dkdv_reference", "flash_bwd_dq_reference"):
        orig = getattr(fa, name)

        def spy(q3, k3, v3, do3, *rest, _orig=orig):
            seen.append(do3.is_contiguous())
            return _orig(q3, k3, v3, do3, *rest)

        monkeypatch.setattr(fa, name, spy)
    got = fa.flash_bwd(*args, strided)
    assert seen == [True, True]
    for a, b in zip(got, fa.flash_bwd(*args, _t(do))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_bwd_dq(*args[:3], strided, args[4], args[5], (args[3] * _t(do)).sum(-1))


@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("b", (1, 2))
def test_flash_attention_grads_match_jax_grad(causal, b):
    """The autograd function end to end on [B, S, H, D] (b == 1 gives the
    strided views) against ``jax.grad`` through the JAX ``custom_vjp`` with
    the Pallas backward."""
    rng = np.random.default_rng(10 * b + int(causal))
    q, k, v, w = (rng.standard_normal((b, 40, 2, 16)).astype(np.float32) for _ in range(4))

    def jloss(q, k, v):
        o = jax_fa.flash_attention(q, k, v, causal=causal, interpret=True, bwd="pallas")
        return jnp.sum(o * w)

    expect = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (_t(t).requires_grad_() for t in (q, k, v))
    torch.sum(fa.flash_attention(tq, tk, tv, causal=causal) * _t(w)).backward()
    for g, e in zip((tq.grad, tk.grad, tv.grad), expect):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **TOL["float32"])


def test_vit_flash_differentiates_through_the_autograd_function(monkeypatch):
    """``ViT(attn_impl="flash")`` reaches ``flash_bwd`` once per block in
    its backward, and its gradients are those of the plain attention."""
    calls = []
    orig = fa.flash_bwd
    monkeypatch.setattr(fa, "flash_bwd", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32))
    grads = {}
    for impl in ("flash", "xla"):
        model = vit.vit_tiny(attn_impl=impl, device="cpu")
        bridge.load_jax_vit(model, bridge.numpy_vit_params(model, seed=4))
        model(x).square().sum().backward()
        grads[impl] = [p.grad for p in model.parameters()]
    assert len(calls) == 2  # vit_tiny has two blocks
    for a, b in zip(grads["flash"], grads["xla"]):
        # the same f32 function in another order: a few ulps of |g| ~ 1-100
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_bad_backward_inputs_raise():
    q = torch.zeros(2, 8, 16)
    st = torch.zeros(2, 8)
    with pytest.raises(TypeError, match="do"):
        fa.flash_bwd(q, q, q, q, st, st, q.bfloat16())
    with pytest.raises(TypeError, match="float32 m "):
        fa.flash_bwd(q, q, q, q, st.double(), st, q)
    with pytest.raises(TypeError, match="delta"):
        fa.flash_bwd(q, q, q, q, st, st, q, delta=torch.zeros(2, 9))
    with pytest.raises(TypeError, match="grad_dtype"):
        fa.flash_bwd(q, q, q, q, st, st, q, grad_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_bwd(q.transpose(0, 1).contiguous().transpose(0, 1), q, q, q, st, st, q)
    with pytest.raises(ValueError, match="o has shape"):
        fa.flash_bwd(q, q, q, torch.zeros(2, 9, 16), st, st, q)
    meta = torch.zeros(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd(meta, meta, meta, meta, st.to("meta"), st.to("meta"), meta)
    with pytest.raises(RuntimeError, match="not differentiable"):
        fa.flash_bwd(q.clone().requires_grad_(), q, q, q, st, st, q)


# -- the two routes: bf16 on the tensor cores (P, dS rounded), f32 unrounded


def _direct_p_ds(q, k, v, do, m, l, delta, causal):
    """P and dS written out once more in f32, op for op as before the
    tensor-core route existed."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    mask = torch.ones(s.shape[-2:], dtype=torch.bool)
    if causal:
        mask = torch.arange(s.shape[-2])[:, None] >= torch.arange(s.shape[-1])[None, :]
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    p = p / torch.clamp(l, min=1e-30)[..., None]
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta[..., None]) * scale
    return p, ds


def _bwd_args(causal, dtype):
    (q, k, v, do), (out, m, l), _ = _case(causal, 77, 16, dtype)
    q3, k3, v3, do3 = (_t(a, dtype) for a in (q, k, v, do))
    m3, l3 = _t(m), _t(l)
    delta = (do3.float() * _t(out, dtype).float()).sum(-1)
    return q3, k3, v3, do3, m3, l3, delta


@pytest.mark.parametrize("causal", (False, True))
def test_f32_plain_backward_is_unchanged_bit_for_bit(causal):
    args = _bwd_args(causal, "float32")
    q, k, v, do = args[:4]
    p, ds = _direct_p_ds(*args, causal)
    dk, dv = fa.flash_bwd_dkdv_reference(*args, causal)
    assert torch.equal(dk, torch.matmul(ds.transpose(-1, -2), q))
    assert torch.equal(dv, torch.matmul(p.transpose(-1, -2), do))
    assert torch.equal(fa.flash_bwd_dq_reference(*args, causal), torch.matmul(ds, k))


@pytest.mark.parametrize("causal", (False, True))
def test_bf16_plain_backward_rounds_p_and_ds_where_the_tensor_cores_do(causal):
    """bf16 inputs: P and dS enter dV = P^T dO, dK = dS^T Q and dQ = dS K as
    bf16 (the tensor cores' operands); everything else stays f32."""
    args = _bwd_args(causal, "bfloat16")
    q, k, _, do = (t.float() for t in args[:4])
    p, ds = _direct_p_ds(*(t.float() for t in args[:4]), *args[4:], causal)
    r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    dk, dv = fa.flash_bwd_dkdv_reference(*args, causal, torch.float32)
    assert torch.equal(dk, torch.matmul(r(ds).transpose(-1, -2), q))
    assert torch.equal(dv, torch.matmul(r(p).transpose(-1, -2), do))
    dq = fa.flash_bwd_dq_reference(*args, causal, torch.float32)
    assert torch.equal(dq, torch.matmul(r(ds), k))
    # the rounding is there, and within the file's bf16 tolerance
    for got, unrounded in ((dk, torch.matmul(ds.transpose(-1, -2), q)),
                           (dq, torch.matmul(ds, k))):
        assert not torch.equal(got, unrounded)
        np.testing.assert_allclose(got.numpy(), unrounded.numpy(), **TOL["bfloat16"])


@pytest.mark.parametrize("causal", (False, True))
def test_bf16_flash_attention_grads_match_jax_grad(causal):
    """bf16 inputs end to end through the autograd function (the rounding
    plain versions on the CPU) against ``jax.grad`` through the JAX
    ``custom_vjp`` with the Pallas backward, which keeps P and dS in f32:
    the bf16 tolerance covers the rounding."""
    rng = np.random.default_rng(20 + int(causal))
    q, k, v = (_bf16_round(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
               for _ in range(3))
    w = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)

    def jloss(q, k, v):
        o = jax_fa.flash_attention(q, k, v, causal=causal, interpret=True, bwd="pallas")
        return jnp.sum(o.astype(jnp.float32) * w)

    expect = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    tq, tk, tv = (_t(t, "bfloat16").requires_grad_() for t in (q, k, v))
    torch.sum(fa.flash_attention(tq, tk, tv, causal=causal).float() * _t(w)).backward()
    for g, e in zip((tq.grad, tk.grad, tv.grad), expect):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(e, np.float32),
                                   **TOL["bfloat16"])


@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("d", (16, 64))
def test_bf16_flash_bwd_matches_jax_bwd_pallas(causal, d):
    """bf16 inputs through the port's ``flash_bwd`` (dS rounded to bf16 in
    dQ as in dK/dV) against the JAX Pallas backward in interpret mode,
    which keeps P and dS in f32: the file's bf16 tolerance covers the
    rounding."""
    (q, k, v, do), (out, m, l), expect = _case(causal, 77, d, "bfloat16")
    got = fa.flash_bwd(*(_t(a, "bfloat16") for a in (q, k, v, out)), _t(m), _t(l),
                       _t(do, "bfloat16"), causal)
    for name, g, e in zip(("dq", "dk", "dv"), got, expect):
        assert g.dtype == torch.bfloat16 and g.shape == (H, 77, d), name
        np.testing.assert_allclose(g.float().numpy(), e, **TOL["bfloat16"], err_msg=name)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_dq_launches_mma_moves_only_with_a_tensor_core_launch(dtype, monkeypatch):
    """``flash_bwd_dq.launches_mma`` counts the launches of the bf16
    tensor-core route: a CPU call moves no count, an f32 launch moves
    ``launches`` alone, a bf16 launch both, and a misaligned bf16 input is
    refused before any launch. The launch itself is stubbed: the kernel
    runs only on the card."""
    args = _bwd_args(False, dtype)
    monkeypatch.setattr(fa.flash_bwd_dq, "launches", 0)
    monkeypatch.setattr(fa.flash_bwd_dq, "launches_mma", 0)
    fa.flash_bwd_dq(*args)
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dq.launches_mma) == (0, 0)

    calls = []
    monkeypatch.setattr(fa, "_placement", lambda name, *tensors: "cuda")
    monkeypatch.setattr(fa, "_call", lambda source, device, *a: calls.append((source, a)))
    fa.flash_bwd_dq(*args)
    bf16 = dtype == "bfloat16"
    assert [source for source, _ in calls] == ["flash_attention_bwd_dq"]
    assert calls[0][1][-3:-1] == (int(bf16), int(bf16))  # in_dtype, out_dtype codes
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dq.launches_mma) == (1, int(bf16))
    if bf16:
        flat = torch.zeros(args[1].numel() + 8, dtype=torch.bfloat16)
        bad = flat[1:args[1].numel() + 1].view(args[1].shape)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_bwd_dq(args[0], bad, *args[2:])
        assert len(calls) == 1 and fa.flash_bwd_dq.launches == 1
