"""The port's DP x PP step (GPipe over the pipe axis of ``[data, pipe] =
[2, 2]`` and ``[1, 4]`` meshes of 4 gloo ranks,
``tests/torch_ranks.py::pp_step_rank``) held against the JAX package's
``make_train_step(pp_axis="pipe")`` on the same device meshes and against
the one-device step, over 3 SGD steps from the same weights on the same
batches (``tests/test_pipeline_parallel_training.py``'s check); the
replicated leaves' gradients are the same on every rank of a pipe group;
the collectives a step issues; the checkpoint's gather of the stages."""

import numpy as np
import pytest
from model_parallel_jax import (LOSS_TOL, SAME_TOL, SINGLE_TOL, assert_params, batches,
                                single_device_run)
from pipeline_jax import PP_KW, pp_jax_run, pp_model, pp_params
from torch_ranks import pp_step_rank, run_ranks

# (pp, tp, interleave, microbatches, step kwargs), and the JAX mesh of each
CASES = ((2, 1, 1, 0, {}), (4, 1, 1, 0, {}))
MESHES = (([2, 2], ["data", "pipe"]), ([1, 4], ["data", "pipe"]))


@pytest.fixture(scope="module")
def dp_pp():
    batch_list = batches(16, 5)
    want = [pp_jax_run(batch_list, *m) for m in MESHES]
    single = single_device_run(pp_model(), pp_params(), batch_list)
    ranks = run_ranks(pp_step_rank, 4, CASES, PP_KW, pp_params(), batch_list, timeout=90)
    return ranks, want, single


@pytest.mark.parametrize("case", [0, 1], ids=["dp2-pp2", "dp1-pp4"])
def test_the_dp_pp_step_matches_the_jax_pp_step_and_one_device(dp_pp, case):
    ranks, want, (one_losses, one_params) = dp_pp
    want_losses, want_params = want[case]
    for r in ranks:
        np.testing.assert_allclose(r[case]["losses"], want_losses, **SAME_TOL)
        assert_params(r[case]["params"], want_params, SAME_TOL, "vs the JAX PP step")
        np.testing.assert_allclose(r[case]["losses"], one_losses, **LOSS_TOL)
        assert_params(r[case]["params"], one_params, SINGLE_TOL, "vs one device")


@pytest.mark.parametrize("case", [0, 1], ids=["dp2-pp2", "dp1-pp4"])
def test_the_replicated_leaves_train_alike_on_every_stage(dp_pp, case):
    """The embedding, the positions, ``ln_f`` and the head take the same
    gradients on every rank of a pipe group (``copy_to_pipe``'s all-reduced
    cotangent, the same logits from ``reduce_from_pipe``), and so hold the
    same weights and momentum after 3 steps, bit for bit, on every rank."""
    ranks, _, _ = dp_pp
    first = ranks[0][case]["shared"]
    assert sorted(first) == ["head.bias", "head.weight", "ln_f.bias", "ln_f.weight", "patch.bias",
                             "patch.weight", "pos"]
    for r in ranks[1:]:
        for name, (w, mom) in r[case]["shared"].items():
            np.testing.assert_array_equal(w, first[name][0], err_msg=name)
            np.testing.assert_array_equal(mom, first[name][1], err_msg=name)


def test_a_pp_step_hands_off_on_active_ticks_and_reduces_over_the_data_axis(dp_pp):
    """3 steps at M = S microbatches: stage 0 and the last stage exchange
    on M ticks a pass, a middle stage on M + 1, each way; one all-reduce
    each way for the conjugate pair; the gradient mean over the data axis
    and the metrics'."""
    ranks, _, _ = dp_pp
    for case, pp in enumerate((2, 4)):
        for rank, r in enumerate(ranks):
            d = rank % pp
            ticks = 3 * (pp + (0 if d in (0, pp - 1) else 1))
            assert r[case]["counts"] == {
                "comm.ppermute.pipe": ticks, "comm.ppermute.pipe_grad": ticks,
                "comm.all_reduce.pipe": 3, "comm.all_reduce.pipe_grad": 3,
                "comm.all_reduce.grad": 3, "comm.all_reduce.metrics": 3}, (case, rank)


def test_a_pp_checkpoint_gathers_the_stages_to_rank_0_alone(dp_pp):
    """The checkpoint's flatten (``dst=0``) gathers every stage's rows and
    their momentum to rank 0 only, in JAX's stacked layout (the same arrays
    every rank gets from the all-gather); the other ranks hold None."""
    ranks, _, _ = dp_pp
    saved, gathered = ranks[0][1]["saved"], ranks[0][1]["gathered"]
    assert saved.keys() == gathered.keys()
    for k in saved:
        np.testing.assert_array_equal(saved[k], gathered[k], err_msg=k)
    assert saved["['params']['blocks']['qkv']['w']"].shape == (4, 32, 96)
    assert saved["['opt_state']['blocks']['mlp2']['w']"].shape == (4, 128, 32)
    assert [r[1]["saved"] is None for r in ranks] == [False, True, True, True]
