"""The port's interleaved pipeline step (pp 2 x v 2: 4 chunks of one
block, over the pipe axis of a ``[data, pipe] = [2, 2]`` mesh of 4 gloo
ranks, ``tests/torch_ranks.py::pp_step_rank``) held against the JAX
package's ``make_train_step(pp_axis="pipe")`` of the interleaved
``ViTPipelineDef`` on the same device mesh and against the one-device step
(which runs the blocks back in logical order), over 3 SGD steps from the
same weights in storage order, at ``M == S`` (the lap-boundary buffer of
depth 1) and ``M > S`` (depth 3); and the exchanges a step issues, the wrap
only at the lap boundary (``tests/test_pipeline_interleaved.py``'s
checks)."""

import numpy as np
import pytest
from model_parallel_jax import (LOSS_TOL, SAME_TOL, SINGLE_TOL, assert_params, batches,
                                single_device_run)
from pipeline_jax import PP_KW, pp_jax_run, pp_model, pp_params
from torch_ranks import pp_step_rank, run_ranks

MICRO = (2, 4)  # the data row's 4 examples as 2 microbatches of 2, or 4 of 1


@pytest.fixture(scope="module")
def interleaved():
    batch_list = batches(16, 5)
    want = [pp_jax_run(batch_list, [2, 2], ["data", "pipe"], interleave=2, n_micro=m)
            for m in MICRO]
    single = single_device_run(pp_model(2, 2), pp_params(2, 2), batch_list)
    ranks = run_ranks(pp_step_rank, 4, [(2, 1, 2, m, {}) for m in MICRO], PP_KW,
                      pp_params(2, 2), batch_list, timeout=90)
    return ranks, want, single


@pytest.mark.parametrize("case", [0, 1], ids=["m-eq-s", "m-gt-s"])
def test_the_interleaved_step_matches_the_jax_step_and_one_device(interleaved, case):
    ranks, want, (one_losses, one_params) = interleaved
    want_losses, want_params = want[case]
    for r in ranks:
        np.testing.assert_allclose(r[case]["losses"], want_losses, **SAME_TOL)
        assert_params(r[case]["params"], want_params, SAME_TOL, "vs the JAX interleaved step")
        np.testing.assert_allclose(r[case]["losses"], one_losses, **LOSS_TOL)
        assert_params(r[case]["params"], one_params, SINGLE_TOL, "vs one device")


@pytest.mark.parametrize("case", [0, 1], ids=["m-eq-s", "m-gt-s"])
def test_an_interleaved_step_sends_the_wrap_at_the_lap_boundary_only(interleaved, case):
    """A pass of 2 x M chunk-ticks a stage: stage 0 sends on each and
    receives the M - ... wraps of stage 1's first lap within them, stage 1
    receives on each and sends its first lap's M around the ring: 2M
    exchanges a pass each way, 3 steps."""
    ranks, _, _ = interleaved
    m = MICRO[case]
    for r in ranks:
        assert r[case]["counts"]["comm.ppermute.pipe"] == 3 * 2 * m
        assert r[case]["counts"]["comm.ppermute.pipe_grad"] == 3 * 2 * m
