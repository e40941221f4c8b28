"""The global-norm clip under pipeline parallelism: the port's step with a
clip tight enough to engage, over ``[data, pipe] = [2, 2]`` and Megatron
PP×TP ``[data, pipe, model] = [1, 2, 2]`` (4 gloo ranks,
``tests/torch_ranks.py::pp_step_rank``), held against the JAX package's
clipped ``make_train_step(pp_axis="pipe")`` on the same device meshes and
against the clipped one-device step (``tests/test_pp_tp_training.py``'s
check): the squares of a stage's leaves are summed over the pipe group, of
its Megatron shards over the joined ``pipe,model`` group, once a step
each."""

import numpy as np
import pytest
from model_parallel_jax import (LOSS_TOL, SAME_TOL, SINGLE_TOL, assert_params, batches,
                                single_device_run)
from pipeline_jax import PP_KW, pp_jax_run, pp_model, pp_params
from torch_ranks import pp_step_rank, run_ranks

CLIP = 0.1  # the JAX test's: below the gradients' global norm at every step
# (pp, tp, interleave, microbatches, step kwargs), and the JAX mesh of each
CASES = ((2, 1, 1, 0, {"grad_clip_norm": CLIP}), (2, 2, 1, 0, {"grad_clip_norm": CLIP}),
         (2, 1, 1, 0, {}))  # the last unclipped, to show the clip engages
MESHES = (([2, 2], ["data", "pipe"]), ([1, 2, 2], ["data", "pipe", "model"]))


@pytest.fixture(scope="module")
def clipped():
    batch_list = batches(16, 5)
    want = [pp_jax_run(batch_list, *m, grad_clip_norm=CLIP) for m in MESHES]
    single = single_device_run(pp_model(), pp_params(), batch_list, grad_clip_norm=CLIP)
    ranks = run_ranks(pp_step_rank, 4, CASES, PP_KW, pp_params(), batch_list, timeout=90)
    return ranks, want, single


@pytest.mark.parametrize("case", [0, 1], ids=["dp2-pp2", "pp2-tp2"])
def test_the_clipped_step_matches_the_jax_step_and_one_device(clipped, case):
    ranks, want, (one_losses, one_params) = clipped
    want_losses, want_params = want[case]
    for r in ranks:
        np.testing.assert_allclose(r[case]["losses"], want_losses, **SAME_TOL)
        assert_params(r[case]["params"], want_params, SAME_TOL, "vs the JAX clipped step")
        np.testing.assert_allclose(r[case]["losses"], one_losses, **LOSS_TOL)
        assert_params(r[case]["params"], one_params, SINGLE_TOL, "vs one device")


def test_the_clip_engages_and_sums_over_its_groups(clipped):
    """The clipped run trains elsewhere than the unclipped one from its
    second step on (the same first loss), and the clip all-reduces once a
    step over the pipe group, and under PP×TP once more over the joined
    group."""
    ranks, _, _ = clipped
    for r in ranks:
        clip, plain = r[0]["losses"], r[2]["losses"]
        assert clip[0] == plain[0] and clip[1:] != plain[1:]
        assert r[0]["counts"]["comm.all_reduce.clip"] == 3
        assert r[1]["counts"]["comm.all_reduce.clip"] == 3 * 2
        assert "comm.all_reduce.clip" not in r[2]["counts"]
