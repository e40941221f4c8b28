"""The port's fused SGD (``tpu_dist_torch.ops.fused_sgd``), its ``SGD``
optimizer and its learning-rate schedules, held against the JAX package:
``fused_sgd_leaf`` in Pallas interpret mode, ``train.optim.SGD`` and the
schedule functions. Parameters, gradients and learning rates come from a
numpy seed and go to both sides as the same arrays.

On the CPU ``fused_sgd`` runs its plain version; the CUDA kernel is held
bit for bit against the same plain version on the card by ``chip_smoke.py``.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
import torch_ranks  # noqa: F401  (one torch thread in this process)

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


# -- the launch plan (pure Python), held against a model of the kernel's walk --

TILES = (1024, 2048, fs.TILE)  # the tiles csrc/fused_sgd.cu builds at VEC 1, 2, 4
LENGTHS = st.one_of(
    st.sampled_from([0, 1, 3, 4, 5, 64, 100, 512]),
    st.integers(0, 64).map(lambda k: 4 * k + 1),
    st.sampled_from(TILES).flatmap(lambda t: st.sampled_from([t - 1, t, t + 1, 3 * t + 2])),
)


def _walk(first, lengths, tile, grid, ptrs=None):
    """A model of the kernel's walk over one launch (``fused_sgd_kernel`` in
    ``csrc/fused_sgd.cu``): ``(cta, leaf, start, stop, vector)`` for every
    tile each of ``grid`` CTAs takes (tile ``cta``, ``cta + grid``, ...),
    ``leaf`` indexing the launch's leaves. ``vector`` is whether the tile
    takes the float4 path: all three of the leaf's ``(p, g, b)`` byte
    addresses in ``ptrs`` 16-byte aligned."""
    n_tiles = first[-1]
    for cta in range(grid):
        leaf = 0
        for t in range(cta, n_tiles, grid):
            while first[leaf + 1] <= t:
                leaf += 1
            start = (t - first[leaf]) * tile
            vector = ptrs is not None and not (ptrs[leaf][0] | ptrs[leaf][1] | ptrs[leaf][2]) & 15
            yield cta, leaf, start, min(start + tile, lengths[leaf]), vector


def _covered(launches, lengths, tile, grid):
    """{leaf: [(start, stop), ...]} over every tile every CTA takes."""
    spans = {}
    for leaves, first in launches:
        for _, k, start, stop, _ in _walk(first, [lengths[i] for i in leaves], tile, grid):
            spans.setdefault(leaves[k], []).append((start, stop))
    return spans


def test_the_plan_uses_the_sizes_the_kernel_is_built_with():
    """``TILE`` and ``MAX_LEAVES`` here are the defaults of
    ``csrc/fused_sgd.cu`` (its entry point refuses a table planned for
    another tile), and a full table fits CUDA's parameter limit."""
    src = (Path(fs.__file__).resolve().parent.parent / "csrc" / "fused_sgd.cu").read_text()
    define = {m[0]: int(m[1]) for m in re.findall(r"#define (FUSED_SGD_\w+) (\d+)", src)}
    assert fs.TILE == 256 * 4 * define["FUSED_SGD_VEC"]
    assert fs.MAX_LEAVES == define["FUSED_SGD_MAX_LEAVES"]
    assert 40 * fs.MAX_LEAVES + 16 + 32 <= 32_764  # sizeof(LeafTable) + the other parameters


@settings(max_examples=60, deadline=None)
@given(lengths=st.lists(LENGTHS, min_size=1, max_size=40), tile=st.sampled_from(TILES),
       grid=st.integers(1, 9), max_leaves=st.integers(1, 50))
def test_tile_walk_covers_every_element_of_every_leaf_once(lengths, tile, grid, max_leaves):
    launches = fs.split_launches(lengths, tile, max_leaves)
    spans = _covered(launches, lengths, tile, grid)
    assert sorted(spans) == [i for i, n in enumerate(lengths) if n > 0]  # empty leaves: no tile
    for i, s in spans.items():
        s.sort()
        assert s[0][0] == 0 and s[-1][1] == lengths[i]
        assert all(a[1] == b[0] for a, b in zip(s, s[1:]))  # no gap, no overlap
        assert all(0 < stop - start <= tile and start % tile == 0 for start, stop in s)


def test_many_tiny_leaves_share_the_ctas():
    """ResNet-style BN leaves: each is one partial tile, walked by the same
    persistent CTAs as the large leaves (no CTA of its own)."""
    lengths = [64] * 40 + [100] + [3 * fs.TILE + 7]
    (leaves, first), = fs.split_launches(lengths)
    assert first[-1] == 41 + 4
    tiles = list(_walk(first, lengths, fs.TILE, grid=8))
    assert len(tiles) == first[-1] and {cta for cta, *_ in tiles} == set(range(8))


def _leaf_set(seed, shapes, offset=0):
    """f32 p, g, b per shape on the CPU; with ``offset``, g starts
    ``offset`` elements into a larger buffer."""
    gen = torch.Generator().manual_seed(seed)
    ps = [torch.randn(s, generator=gen) for s in shapes]
    gs = [torch.randn(math.prod(s) + offset, generator=gen)[offset:].view(s) for s in shapes]
    bs = [torch.zeros(s) for s in shapes]
    return ps, gs, bs


@pytest.mark.parametrize("offset", (0, 1, 2, 3), ids=lambda o: f"g+{4 * o}B")
def test_vector_tiles_start_16_byte_aligned(offset):
    shapes = [(fs.TILE + 5,), (3,), (2, fs.TILE), (129,)]
    ps, gs, bs = _leaf_set(0, shapes, offset)
    assert all(t.data_ptr() % 16 == 0 for t in ps + bs)
    plan = fs.make_plan(ps, gs, bs)
    (one,) = plan.launches
    ptrs = [(ps[i].data_ptr(), gs[i].data_ptr(), bs[i].data_ptr()) for i in one.leaves]
    tiles = list(_walk(one.first, one.lengths, fs.TILE, 3, ptrs))
    assert len(tiles) == one.first[-1]
    for _, k, start, _, vector in tiles:
        assert vector == (offset == 0)  # a misaligned g sends its leaf down the scalar path
        if vector:
            assert all((a + 4 * start) % 16 == 0 for a in ptrs[k])


def test_a_table_past_the_parameter_limit_splits_into_launches():
    # 2 * MAX_LEAVES + 5 leaves with work, and an empty one after every 6th
    lengths = [0 if i % 7 == 6 else 1 + i % 5 * 3 for i in range((2 * fs.MAX_LEAVES + 5) * 7 // 6)]
    assert sum(k > 0 for k in lengths) == 2 * fs.MAX_LEAVES + 5
    ps = [torch.zeros(k) for k in lengths]
    gs = [torch.zeros(k) for k in lengths]
    bs = [torch.zeros(k) for k in lengths]
    plan = fs.make_plan(ps, gs, bs)
    assert len(plan.launches) == 3 and plan.device == -1
    assert ([i for one in plan.launches for i in one.leaves]
            == [i for i, k in enumerate(lengths) if k])
    for one in plan.launches:
        m = len(one.leaves)
        assert 0 < m <= fs.MAX_LEAVES and 40 * m + 16 <= 32_764  # the kernel's parameter bytes
        table = list(one.table)
        assert len(table) == 5 * m + 1
        assert table[:m + 1] == list(one.first) and table[m + 1:2 * m + 1] == list(one.lengths)
        for j, ts in enumerate((ps, gs, bs)):
            assert table[(2 + j) * m + 1:(3 + j) * m + 1] == [ts[i].data_ptr() for i in one.leaves]
    spans = _covered([(one.leaves, one.first) for one in plan.launches], lengths, fs.TILE, 4)
    assert sum(stop - start for s in spans.values() for start, stop in s) == sum(lengths)


def _change(kind, g):
    if kind == "moved":
        return g.clone()
    if kind == "resized":
        return torch.zeros(g.numel() + 4)
    if kind == "reshaped":
        return g.view(g.shape[::-1])  # same pointer, same length
    if kind == "retyped":
        return g.double()
    return torch.zeros(g.shape[::-1]).t()  # non-contiguous, same shape


@pytest.mark.parametrize("kind,error", [("moved", None), ("resized", ValueError),
                                        ("reshaped", ValueError), ("retyped", TypeError),
                                        ("non-contiguous", ValueError)])
@pytest.mark.parametrize("which", ("p", "g", "b"))
def test_plan_cache_never_reuses_a_stale_plan(kind, error, which):
    shapes = [(7,), (4, 6)]  # the second changes
    leaves = list(_leaf_set(1, shapes))
    cache = fs.PlanCache()
    plan = cache.get(*leaves)
    assert cache.get(*[list(ts) for ts in leaves]) is plan  # same leaves, new lists: a hit
    assert (cache.hits, cache.misses) == (1, 1)
    slot = "pgb".index(which)
    leaves[slot] = [leaves[slot][0], _change(kind, leaves[slot][1])]
    if error:
        with pytest.raises(error):
            cache.get(*leaves)
        assert (cache.hits, cache.misses) == (1, 2)
        return
    new = cache.get(*leaves)
    assert new is not plan and (cache.hits, cache.misses) == (1, 2)
    table = list(new.launches[0].table)
    assert leaves[slot][1].data_ptr() in table and leaves[slot][1].data_ptr() not in list(
        plan.launches[0].table)


def test_plan_cache_keeps_a_few_leaf_sets():
    cache = fs.PlanCache(size=2)
    sets = [_leaf_set(s, [(5,)]) for s in range(3)]
    plans = [cache.get(*s) for s in sets]
    assert cache.get(*sets[2]) is plans[2] and cache.get(*sets[1]) is plans[1]
    assert cache.get(*sets[0]) is not plans[0]  # the oldest was dropped
    assert (cache.hits, cache.misses) == (2, 4)


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
