"""The port's DP x EP step (the ViT-MoE over a ``[data, expert] = [2, 2]``
mesh of 4 gloo ranks, ``tests/torch_ranks.py::ep_step_rank``) held against
the JAX package's ``make_train_step(ep_axis="expert")`` on a 2 x 2 device
mesh, over 3 SGD steps from the same weights on the same batches, each
device's rows the same on both sides: top-1 and top-2 routing, some tokens
over their expert's capacity, the load-balancing loss at JAX's default
coefficient, and the shard-aware global-norm clip. Also the collectives a
step issues."""

import jax
import numpy as np
import pytest
from model_parallel_jax import (MOE_KW, SAME_TOL, assert_params, batches, jax_run, mesh_of,
                                moe_model, moe_params)
from torch_ranks import ep_step_rank, run_ranks

# (ep, top_k, grad_clip_norm): the clip is low enough to act on every step
CASES = ((2, 1, 0.0), (2, 2, 0.5))


@pytest.fixture(scope="module")
def runs():
    batch_list = batches(16, 5, n=8)
    mesh2d = mesh_of([2, 2], ["data", "expert"])
    want, ranks_in = [], []
    for ep, k, clip in CASES:
        md = moe_model(k)
        params = moe_params(k)
        ranks_in.append(params)
        want.append(jax_run(md, params, mesh2d, batch_list, specs=md.ep_param_specs("expert"),
                            batch_axes=("data", "expert"), ep_axis="expert",
                            grad_clip_norm=clip))
    # every case starts from the same JAX init (top_k does not enter it)
    for a, b in zip(*(jax.tree_util.tree_leaves(p) for p in ranks_in)):
        assert np.array_equal(a, b)
    return run_ranks(ep_step_rank, 4, CASES, MOE_KW, ranks_in[0], batch_list, timeout=90), want


@pytest.mark.parametrize("i", range(len(CASES)), ids=[f"k{k}-clip{c}" for _, k, c in CASES])
def test_dp_ep_step_matches_the_jax_ep_step(runs, i):
    """The losses (cross-entropy plus 0.01 times the routers' load-balancing
    loss, the mean over every rank) and the gathered parameters: the
    expert slabs take the data mean divided by the expert group's size,
    every other leaf the mean over every rank."""
    ranks, want = runs
    want_losses, want_params = want[i]
    for r in ranks:
        np.testing.assert_allclose(r[i]["losses"], want_losses, **SAME_TOL)
        assert_params(r[i]["params"], want_params, SAME_TOL, f"case {CASES[i]}")


def test_an_ep_step_exchanges_twice_a_block_each_way(runs):
    """A step of 1 MoE block: the dispatch and the return exchange forward
    and backward, one mean over every rank (the replicated leaves), one over
    the data axis (the slabs), the metrics; the clip's one reduce of the
    slabs' squares over the expert group."""
    ranks, _ = runs
    common = {"comm.all_to_all.moe": 6, "comm.all_to_all.moe_grad": 6,
              "comm.all_reduce.grad": 3, "comm.all_reduce.grad_ep": 3,
              "comm.all_reduce.metrics": 3}
    assert ranks[0][0]["counts"] == common
    assert ranks[0][1]["counts"] == {**common, "comm.all_reduce.clip": 3}
