"""The port's pipeline schedule (``tpu_dist_torch/parallel/pipeline.py``)
held against the JAX package's ``pipeline_apply`` and
``pipeline_apply_interleaved`` on the toy stage of its own tests
(``tests/test_parallel.py``: ``tanh(h @ w)``): a pipe group of 4 gloo ranks
(``tests/torch_ranks.py::pp_toy_rank``) against ``shard_map`` over 4 CPU
devices, forward and each rank's gradients, GPipe and the interleaved
schedule at ``M == S`` and ``M > S``; the exchanges a pass issues (active
ticks only, the wrap only at a lap boundary); ``bubble_fraction``; the
schedule's refusal of ``M < S``; the lockstep runner."""

import numpy as np
import pytest
import torch
from pipeline_jax import toy_inputs, toy_jax
from torch_ranks import pp_toy_rank, run_ranks

from tpu_dist.parallel.pipeline import bubble_fraction as jax_bubble_fraction
from tpu_dist_torch.parallel import pipeline

N = 4
# f32: the same products and tanh on both sides, XLA's dot vs PyTorch's, a
# few ulps through 4 (or 8) stages
TOL = dict(rtol=1e-5, atol=1e-6)
# (interleave, microbatches): GPipe; interleaved at M == S (a lap-boundary
# buffer of depth 1) and M > S (depth 3)
CASES = ((1, 4), (2, 4), (2, 6))


@pytest.fixture(scope="module")
def runs():
    out = {}
    for v, m in CASES:
        ws, x, ct = toy_inputs(N * v, n_micro=m)
        want = toy_jax(ws, x, ct, N, v)
        got = run_ranks(pp_toy_rank, N, [v], ws, x, ct, timeout=90)
        out[(v, m)] = (want, [r[0] for r in got])
    return out


@pytest.mark.parametrize("v,m", CASES, ids=["gpipe", "interleaved-m-eq-s",
                                            "interleaved-m-gt-s"])
def test_the_pipeline_matches_jax_forward_and_gradients(runs, v, m):
    (want_y, want_g), ranks = runs[(v, m)]
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["y"], want_y, **TOL)
        np.testing.assert_allclose(r["g"], want_g[rank], **TOL)


@pytest.mark.parametrize("v,m", CASES, ids=["gpipe", "interleaved-m-eq-s",
                                            "interleaved-m-gt-s"])
def test_a_pass_exchanges_on_active_ticks_only(runs, v, m):
    """One ``batch_isend_irecv`` a tick that moves something: a stage sends
    each of its ``v·M`` outputs but the last virtual stage's ``M`` and
    receives what the stage before sends, so stage 0 and the last stage
    exchange on ``v·M`` ticks (GPipe: ``M``), a middle stage on ``v·M + 1``;
    the backward the same; the conjugate pair one all-reduce each way."""
    _, ranks = runs[(v, m)]
    for rank, r in enumerate(ranks):
        ticks = v * m + (0 if rank in (0, N - 1) else 1)
        assert r["counts"] == {"comm.ppermute.pipe": ticks, "comm.ppermute.pipe_grad": ticks,
                               "comm.all_reduce.pipe": 1}, rank


def test_bubble_fraction_is_jaxs():
    for s, m, v in ((4, 4, 1), (4, 4, 2), (4, 8, 2), (2, 1, 1), (8, 16, 4)):
        assert pipeline.bubble_fraction(s, m, v) == jax_bubble_fraction(s, m, v)
    assert pipeline.bubble_fraction(4, 4) == 3 / 7
    assert pipeline.bubble_fraction(4, 8, 2) < pipeline.bubble_fraction(4, 4, 2) < 3 / 7


def test_the_schedule_runs_each_stage_on_its_active_ticks():
    """Stage ``d`` is busy ticks ``[d, d + vM)``, chunk ``r // M`` on
    microbatch ``r % M``; stage 0 past its first lap reads the wrap, and the
    last virtual stage writes the result."""
    sched = pipeline.schedule(3, 4, 2)
    assert len(sched) == 2 * 4 + 3 - 1
    for d in range(3):
        busy = [t for t, row in enumerate(sched) if row[d] is not None]
        assert busy == list(range(d, d + 8))
        assert [(row[d].k, row[d].m) for row in sched if row[d]] == [
            divmod(r, 4) for r in range(8)]
    assert sched[4][0].src == "wrap" and sched[0][0].src == "feed"
    assert sched[2][2].dst == "wrap" and sched[6][2].dst == "out"
    assert all(s.dst != "wrap" for row in pipeline.schedule(3, 2) for s in row if s)


def test_the_interleaved_schedule_refuses_fewer_microbatches_than_stages():
    with pytest.raises(ValueError, match="n_microbatches >= n_stages"):
        pipeline.schedule(4, 2, 2)


@pytest.mark.parametrize("v,m", CASES, ids=["gpipe", "interleaved-m-eq-s",
                                            "interleaved-m-gt-s"])
def test_the_lockstep_runner_is_the_sequential_chain(v, m):
    """Every stage in one process: each microbatch through the ``N·v``
    virtual stages in order, bit for bit (the same ops on the same rows)."""
    ws, x, _ = toy_inputs(N * v, n_micro=m)
    w = torch.tensor(ws)
    fns = [lambda k, h, d=d: torch.tanh(h @ w[k * N + d]) for d in range(N)]
    got = pipeline.pipeline_lockstep(fns, torch.tensor(x), v)
    want = torch.tensor(x)
    for j in range(N * v):
        want = torch.tanh(want @ w[j])
    assert torch.equal(got, want)
