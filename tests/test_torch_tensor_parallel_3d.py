"""The port's DP x TP x SP step (``[data, model, seq] = [2, 2, 2]`` over 8
gloo ranks, ``tests/torch_ranks.py::tp_step_rank``), ring and Ulysses,
held against the JAX package's 3-D step (``make_train_step(tp_axis=
"model", seq_axis="seq")``, ``tests/test_3d_mesh_training.py``'s mesh)
over 3 SGD steps from the same weights on the same batches."""

import numpy as np
import pytest
from model_parallel_jax import (SAME_TOL, TP_KW, assert_params, batches, jax_run, mesh_of,
                                tp_model, tp_params)
from torch_ranks import run_ranks, tp_step_rank

SP_CASES = ((2, 2, "ring"), (2, 2, "ulysses"))


@pytest.fixture(scope="module")
def dp_tp_sp():
    params, batch_list = tp_params(), batches(32, 5)
    md = tp_model()
    mesh3d = mesh_of([2, 2, 2], ["data", "model", "seq"])
    want = {mode: jax_run(md, params, mesh3d, batch_list, specs=md.tp_param_specs("model"),
                          tp_axis="model", seq_axis="seq", model_kwargs={"sp_mode": mode})
            for _, _, mode in SP_CASES}
    return run_ranks(tp_step_rank, 8, SP_CASES, TP_KW, params, batch_list, timeout=120), want


@pytest.mark.parametrize("i", range(len(SP_CASES)), ids=[c[2] for c in SP_CASES])
def test_dp_tp_sp_steps_match_the_jax_3d_step(dp_tp_sp, i):
    """[data, model, seq] = [2, 2, 2]: the local heads' attention runs
    sequence-parallel, the gradients take one mean over the data x seq
    group."""
    ranks, want = dp_tp_sp
    want_losses, want_params = want[SP_CASES[i][2]]
    for r in ranks:
        np.testing.assert_allclose(r[i]["losses"], want_losses, **SAME_TOL)
        assert_params(r[i]["params"], want_params, SAME_TOL, SP_CASES[i][2])
        assert r[i]["counts"]["comm.all_reduce.grad"] == 3
