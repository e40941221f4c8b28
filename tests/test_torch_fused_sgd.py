"""The port's fused SGD (``tpu_dist_torch.ops.fused_sgd``), its ``SGD``
optimizer and its learning-rate schedules, held against the JAX package:
``fused_sgd_leaf`` in Pallas interpret mode, ``train.optim.SGD`` and the
schedule functions. Parameters, gradients and learning rates come from a
numpy seed and go to both sides as the same arrays.

On the CPU ``fused_sgd`` runs its plain version; the CUDA kernel is held
bit for bit against the same plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.ops import fused_sgd as jax_fused
from tpu_dist.train import optim as jax_optim
from tpu_dist_torch.ops import fused_sgd as fs
from tpu_dist_torch.train import optim

SHAPES = [(7,), (768,), (3, 5, 129), (128, 128)]
LRS = (0.1, 0.05, 0.0125)  # one per step

# Both sides compute the same six f32 operations per element; XLA on the
# CPU may contract a multiply and an add into one FMA (one rounding where
# the port has two), so results may differ by an ulp or two of |p| ~ 4.
TOL = dict(rtol=1e-6, atol=1e-6)


def _leaves(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _grads(seed, step, shapes=SHAPES):
    return _leaves(1000 * seed + step + 1, shapes)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fused_sgd_reference_matches_jax_fused_sgd_leaf(shape):
    """Three steps of one leaf, each with new gradients and a new lr."""
    p0 = _leaves(1, [shape])[0]
    jp, jb = jnp.asarray(p0), jnp.zeros(shape, jnp.float32)
    tp, tb = torch.from_numpy(p0.copy()), torch.zeros(shape)
    for step, lr in enumerate(LRS):
        g = _grads(1, step, [shape])[0]
        jp, jb = jax_fused.fused_sgd_leaf(jp, jnp.asarray(g), jb, lr, momentum=0.9,
                                          weight_decay=1e-4, interpret=True)
        fs.fused_sgd_reference([tp], [torch.from_numpy(g)], [tb], lr, momentum=0.9,
                               weight_decay=1e-4)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_fused_sgd_on_cpu_is_the_plain_version_in_place():
    ps, bs = [torch.from_numpy(a) for a in _leaves(2)], [torch.zeros(s) for s in SHAPES]
    ref_p, ref_b = [p.clone() for p in ps], [b.clone() for b in bs]
    ids = [id(t) for t in ps + bs]
    before = fs.fused_sgd.launches
    for step, lr in enumerate(LRS):
        gs = [torch.from_numpy(a) for a in _grads(2, step)]
        fs.fused_sgd(ps, gs, bs, lr)
        fs.fused_sgd_reference(ref_p, gs, ref_b, lr)
    assert fs.fused_sgd.launches == before  # the CPU path launches no kernel
    assert [id(t) for t in ps + bs] == ids  # updated in place
    for a, b in zip(ps + bs, ref_p + ref_b):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused,nesterov", [(False, False), (False, True), (True, False)],
                         ids=("plain", "nesterov", "fused"))
def test_sgd_matches_jax_sgd(fused, nesterov):
    j_opt = jax_optim.SGD(momentum=0.9, weight_decay=1e-4, nesterov=nesterov)
    t_opt = optim.SGD(momentum=0.9, weight_decay=1e-4, nesterov=nesterov, fused=fused)
    p0 = _leaves(3)
    jp = [jnp.asarray(a) for a in p0]
    jb = j_opt.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    tb = t_opt.init(tp)
    assert all(torch.equal(b, torch.zeros_like(p)) for b, p in zip(tb, tp))
    for step, lr in enumerate(LRS):
        g = _grads(3, step)
        jp, jb = j_opt.update([jnp.asarray(a) for a in g], jb, jp, lr)
        out_p, out_b = t_opt.update([torch.from_numpy(a) for a in g], tb, tp, lr)
        assert out_p is tp and out_b is tb
    for t, j in zip(tp + tb, list(jp) + list(jb)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_fused_and_plain_sgd_agree_bit_for_bit():
    """One definition of the six roundings serves both (the card holds the
    kernel to the same bits)."""
    p0 = _leaves(4)
    runs = []
    for fused in (False, True):
        opt = optim.SGD(fused=fused)
        ps = [torch.from_numpy(a.copy()) for a in p0]
        bs = opt.init(ps)
        for step, lr in enumerate(LRS):
            opt.update([torch.from_numpy(a) for a in _grads(4, step)], bs, ps, lr)
        runs.append(ps + bs)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_lr_may_be_a_scalar_tensor():
    p0 = _leaves(5)
    runs = []
    for lr in (0.1, torch.tensor(0.1)):
        ps, bs = [torch.from_numpy(a.copy()) for a in p0], [torch.zeros(s) for s in SHAPES]
        fs.fused_sgd(ps, [torch.from_numpy(a) for a in _grads(5, 0)], bs, lr)
        runs.append(ps + bs)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_fused_nesterov_is_refused():
    with pytest.raises(ValueError, match="nesterov"):
        optim.SGD(nesterov=True, fused=True)
    with pytest.raises(ValueError, match="nesterov"):
        jax_optim.SGD(nesterov=True, fused=True)  # the same refusal in JAX


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16, torch.float64))
def test_non_f32_leaf_is_refused(dtype):
    p, g, b = torch.zeros(4), torch.zeros(4), torch.zeros(4)
    for leaves in (([p.to(dtype)], [g], [b]), ([p], [g.to(dtype)], [b]), ([p], [g], [b.to(dtype)])):
        with pytest.raises(TypeError, match="float32"):
            fs.fused_sgd(*leaves, 0.1)


def test_mismatched_leaves_are_refused():
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="one grad and one buffer"):
        fs.fused_sgd([z], [z, z], [z], 0.1)
    with pytest.raises(ValueError, match="leaf 0"):
        fs.fused_sgd([z], [torch.zeros(5)], [z], 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        m = torch.zeros(4, 4).t()
        fs.fused_sgd([m], [m], [m], 0.1)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fs.fused_sgd([meta], [meta], [meta], 0.1)
    fs.fused_sgd([], [], [], 0.1)  # nothing to update: a no-op


def test_chunk_table_layout():
    """The kernel's table: pointers, lengths and first chunks in leaf order;
    an empty leaf owns no chunk."""
    leaves = [torch.zeros(fs.CHUNK + 1), torch.zeros(0), torch.zeros(3)]
    grads = [torch.zeros_like(t) for t in leaves]
    bufs = [torch.zeros_like(t) for t in leaves]
    table, n_chunks = fs.chunk_table(leaves, grads, bufs)
    assert n_chunks == 3
    assert table[:3] == [t.data_ptr() for t in leaves]
    assert table[3:6] == [t.data_ptr() for t in grads]
    assert table[6:9] == [t.data_ptr() for t in bufs]
    assert table[9:12] == [fs.CHUNK + 1, 0, 3]
    assert table[12:15] == [0, 2, 2]


@pytest.mark.parametrize("milestones,gamma,warmup", [
    ((60, 120, 160), 0.2, 0), ((30, 60, 90), 0.1, 5), ((100,), 0.5, 1),
])
def test_multistep_lr_matches_jax(milestones, gamma, warmup):
    ours = optim.multistep_lr(0.1, milestones, gamma, warmup)
    theirs = jax_optim.multistep_lr(0.1, milestones, gamma, warmup)
    assert [ours(e) for e in range(201)] == [theirs(e) for e in range(201)]


@pytest.mark.parametrize("total,warmup,min_lr", [(200, 0, 0.0), (200, 5, 1e-4), (90, 10, 0.0)])
def test_cosine_lr_matches_jax(total, warmup, min_lr):
    ours = optim.cosine_lr(0.4, total, warmup, min_lr)
    theirs = jax_optim.cosine_lr(0.4, total, warmup, min_lr)
    assert [ours(e) for e in range(201)] == [theirs(e) for e in range(201)]


def test_linear_scaled_lr_matches_jax():
    for base_batch, batch in ((256, 64), (256, 4096), (128, 128)):
        assert optim.linear_scaled_lr(0.1, base_batch, batch) == jax_optim.linear_scaled_lr(
            0.1, base_batch, batch)
    for bad in ((0, 64), (256, 0)):
        with pytest.raises(ValueError):
            optim.linear_scaled_lr(0.1, *bad)
