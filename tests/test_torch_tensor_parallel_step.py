"""The port's DP x TP step (Megatron TP over a ``[data, model] = [2, 2]``
mesh of 4 gloo ranks, ``tests/torch_ranks.py::tp_step_rank``) held against
the JAX package's ``make_train_step(tp_axis="model")`` on a 2 x 2 device
mesh and against the one-device step, over 3 SGD steps from the same
weights on the same batches (``tests/test_tensor_parallel_training.py``'s
check), and the collectives a step issues."""

import numpy as np
import pytest
from model_parallel_jax import (LOSS_TOL, SAME_TOL, SINGLE_TOL, TP_KW, assert_params, batches,
                                jax_run, mesh_of, single_device_run, tp_model, tp_params)
from torch_ranks import run_ranks, tp_step_rank

# the plain f32 wire, and the bf16 wire (which composes with TP in both
# packages; the int8 wires are refused: test_torch_model_parallel_refusals.py)
STEP_CASES = ((2, 1, None), (2, 1, None, {"grad_compression": "bf16"}))


@pytest.fixture(scope="module")
def dp_tp():
    params, batch_list = tp_params(), batches(32, 5)
    md = tp_model()
    mesh2d = mesh_of([2, 2], ["data", "model"])
    want = [jax_run(md, params, mesh2d, batch_list, specs=md.tp_param_specs("model"),
                    tp_axis="model", **(case[3] if len(case) > 3 else {}))
            for case in STEP_CASES]
    single = single_device_run(md, params, batch_list)
    return run_ranks(tp_step_rank, 4, STEP_CASES, TP_KW, params, batch_list, timeout=90), \
        want, single


def test_dp_tp_step_matches_the_jax_tp_step_and_one_device(dp_tp):
    ranks, want, (one_losses, one_params) = dp_tp
    want_losses, want_params = want[0]
    for r in ranks:
        np.testing.assert_allclose(r[0]["losses"], want_losses, **SAME_TOL)
        assert_params(r[0]["params"], want_params, SAME_TOL, "vs the JAX TP step")
        np.testing.assert_allclose(r[0]["losses"], one_losses, **LOSS_TOL)
        assert_params(r[0]["params"], one_params, SINGLE_TOL, "vs one device")


# bf16 wire: both packages round the same f32 gradients to bf16 for the
# mean over the data axis; a sum of 2 in another order can round to the
# neighbouring bf16 value (2^-8 relative) on either side, which lr 0.05
# carries into a weight (|w| <~ 2) as up to ~4e-3 · |g| · lr: well inside
# 1e-4 absolute after 3 steps; the losses stay within the f32 bound
BF16_WIRE_TOL = dict(rtol=1e-4, atol=1e-4)


def test_dp_tp_step_on_the_bf16_wire_matches_jax(dp_tp):
    ranks, want, _ = dp_tp
    want_losses, want_params = want[1]
    for r in ranks:
        np.testing.assert_allclose(r[1]["losses"], want_losses, **SAME_TOL)
        assert_params(r[1]["params"], want_params, BF16_WIRE_TOL, "bf16 wire")


def test_a_tp_step_reduces_each_block_pair_once(dp_tp):
    """A step of 2 blocks: one reduce_from_tp a pair in the forward (2 a
    block), one copy_to_tp backward a pair, one gradient mean over the
    data axis and the metrics."""
    ranks, _, _ = dp_tp
    assert ranks[0][1]["counts"] == ranks[0][0]["counts"]
    assert ranks[0][0]["counts"] == {"comm.all_reduce.tp": 12, "comm.all_reduce.tp_grad": 12,
                                     "comm.all_reduce.grad": 3, "comm.all_reduce.metrics": 3}


def test_a_tp_checkpoint_is_gathered_to_rank_0_alone(dp_tp):
    """The checkpoint's flatten (``dst=0``) gathers the shards and their
    momentum to rank 0 only: rank 0 holds the same full arrays that every
    rank gets from the all-gather, in JAX's layout, and the other ranks
    (rank 1 of its model group, the model group of data row 1) None."""
    ranks, _, _ = dp_tp
    saved, gathered = ranks[0][0]["saved"], ranks[0][0]["gathered"]
    assert saved.keys() == gathered.keys()
    for k in saved:
        np.testing.assert_array_equal(saved[k], gathered[k], err_msg=k)
    assert saved["['params']['blocks'][0]['qkv']['w']"].shape == (32, 96)
    assert saved["['opt_state']['blocks'][0]['mlp2']['w']"].shape == (128, 32)
    assert [r[0]["saved"] is None for r in ranks] == [False, True, True, True]
