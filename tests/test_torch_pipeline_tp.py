"""Megatron PP×TP in the port: the step over ``[data, pipe, model] = [1, 2,
2]`` (4 gloo ranks, each stage's blocks in Megatron shards,
``tests/torch_ranks.py::pp_step_rank``) held against the JAX package's
``make_train_step(pp_axis="pipe", tp_axis="model")`` on the same device
mesh and against the one-device step (``tests/test_pp_tp_training.py``'s
check), and the collectives of its blocks. The clip under PP and PP×TP:
``test_torch_pipeline_clip.py``."""

import numpy as np
import pytest
from model_parallel_jax import (LOSS_TOL, SAME_TOL, SINGLE_TOL, assert_params, batches,
                                single_device_run)
from pipeline_jax import PP_KW, pp_jax_run, pp_model, pp_params
from torch_ranks import pp_step_rank, run_ranks

# (pp, tp, interleave, microbatches, step kwargs)
CASES = ((2, 2, 1, 0, {}),)


@pytest.fixture(scope="module")
def pp_tp():
    batch_list = batches(16, 5)
    want = pp_jax_run(batch_list, [1, 2, 2], ["data", "pipe", "model"])
    single = single_device_run(pp_model(), pp_params(), batch_list)
    ranks = run_ranks(pp_step_rank, 4, CASES, PP_KW, pp_params(), batch_list, timeout=90)
    return [r[0] for r in ranks], want, single


def test_the_pp_tp_step_matches_the_jax_step_and_one_device(pp_tp):
    ranks, (want_losses, want_params), (one_losses, one_params) = pp_tp
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, **SAME_TOL)
        assert_params(r["params"], want_params, SAME_TOL, "vs the JAX PP×TP step")
        np.testing.assert_allclose(r["losses"], one_losses, **LOSS_TOL)
        assert_params(r["params"], one_params, SINGLE_TOL, "vs one device")


def test_a_pp_tp_step_reduces_each_block_pair_once(pp_tp):
    """2 blocks a stage, M = 2 microbatches a pass: one ``reduce_from_tp`` a
    pair in the forward (2 a block) and one ``copy_to_tp`` backward a pair,
    over 3 steps; the pipe's exchanges as under PP alone, over the pipe
    group of this model index."""
    ranks, _, _ = pp_tp
    for r in ranks:
        assert r["counts"] == {
            "comm.all_reduce.tp": 3 * 2 * 2 * 2, "comm.all_reduce.tp_grad": 3 * 2 * 2 * 2,
            "comm.ppermute.pipe": 3 * 2, "comm.ppermute.pipe_grad": 3 * 2,
            "comm.all_reduce.pipe": 3, "comm.all_reduce.pipe_grad": 3,
            "comm.all_reduce.grad": 3, "comm.all_reduce.metrics": 3}


def test_a_pp_tp_checkpoint_is_jaxs_full_stacked_layout(pp_tp):
    """The checkpoint's flatten gathers every stage's rows and every rank's
    shards to rank 0: JAX's full ``[depth, ...]`` leaves, the ones every
    rank gathers; the other ranks hold None."""
    ranks, _, _ = pp_tp
    saved, gathered = ranks[0]["saved"], ranks[0]["gathered"]
    for k in saved:
        np.testing.assert_array_equal(saved[k], gathered[k], err_msg=k)
    assert saved["['params']['blocks']['qkv']['w']"].shape == (4, 32, 96)
    assert saved["['opt_state']['blocks']['proj']['w']"].shape == (4, 32, 32)
    assert [r["saved"] is None for r in ranks] == [False, True, True, True]
