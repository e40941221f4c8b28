"""The port's DP x SP train step on a ``[data=2, seq=2]`` mesh of 4 gloo
ranks (``tests/torch_ranks.py::seq_step_rank``) held against the JAX
package's ``make_train_step(seq_axis="seq")`` on a 2 x 2 device mesh and
over 3 SGD steps from the same weights on the same batches: the ring and
Ulysses with the plain attention, and the collectives a step issues. Each
against the single-device step, the ring flash composition, ZeRO-1 under
the seq axis and the step's refusals are ``test_torch_seq_parallel_zero1.py``.
"""

import jax
import numpy as np
import pytest
from seq_parallel_jax import MODEL_KW, assert_params, jax_run, step_batches, step_params
from torch_ranks import run_ranks, seq_step_rank

from tpu_dist.comm import mesh as mesh_lib

# (sp_mode, attn_impl, zero1)
CASES = (("ring", "xla", False), ("ulysses", "xla", False))
# Against the JAX SP step, the same sharded algorithm: the port's f32 ops
# in another order than XLA's fused ones, a few ulps a step.
SP_TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture(scope="module")
def runs():
    params, batches = step_params(), step_batches()
    mesh2d = mesh_lib.device_mesh([2, 2], ["data", "seq"], jax.devices()[:4])
    jax_runs = {
        "ring": jax_run(params, mesh2d, batches, seq_axis="seq"),
        "ulysses": jax_run(params, mesh2d, batches, seq_axis="seq",
                           model_kwargs={"sp_mode": "ulysses"}),
    }
    return jax_runs, run_ranks(seq_step_rank, 4, CASES, MODEL_KW, params, batches, timeout=120)


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_dp_sp_steps_match_the_jax_sp_step(runs, i):
    jax_runs, ranks = runs
    want_losses, want_params = jax_runs[CASES[i][0]]
    np.testing.assert_allclose(ranks[0][i]["losses"], want_losses, **SP_TOL)
    assert_params(ranks[0][i]["params"], want_params, SP_TOL, CASES[i][0])


def test_the_gradients_take_one_reduce_over_every_rank(runs):
    """A step reduces the gradients once over every rank (the mean over data
    then seq that JAX takes, in one all-reduce) and its metrics once; the
    pooled mean is one differentiable sum over the seq group; the ring
    sends K/V once a block (seq group of 2) each way, Ulysses exchanges
    twice each way."""
    _, ranks = runs
    ring, uly = (c["counts"] for c in ranks[0])
    common = {"comm.all_reduce.grad": 3, "comm.all_reduce.metrics": 3, "comm.all_reduce.seq_pool": 3,
              "comm.all_reduce.seq_pool_grad": 3}
    assert ring == {**common, "comm.ppermute.ring_kv": 6, "comm.ppermute.ring_kv_grad": 6}
    assert uly == {**common, "comm.all_to_all.ulysses": 12, "comm.all_to_all.ulysses_grad": 12}
