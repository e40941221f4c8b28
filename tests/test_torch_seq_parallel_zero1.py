"""The port's DP x SP train step on a ``[data=2, seq=2]`` mesh of 4 gloo
ranks (``tests/torch_ranks.py::seq_step_rank``), part two: the ring and
Ulysses with the plain attention, the ring flash composition (kernels
#1-#3 around the ring, their plain versions on the CPU) and ZeRO-1 under
the seq axis, each held against the JAX package's single-device step over
3 SGD steps, as ``tests/test_seq_parallel_training.py`` holds the JAX step,
and the last two against the plain ring. Then the step's refusals (a seq
group of one is ``test_torch_train_step.py``).
"""

import numpy as np
import pytest
from seq_parallel_jax import (MODEL_KW, assert_matches_single_device, assert_params,
                              single_device_run, step_batches, step_params)
from torch_ranks import run_ranks, seq_step_rank

from tpu_dist_torch.comm.mesh import AxisGroup
from tpu_dist_torch.train import optim, step

# (sp_mode, attn_impl, zero1)
CASES = (("ring", "xla", False), ("ulysses", "xla", False), ("ring", "flash", False),
         ("ring", "xla", True))
IDS = ["ring", "ulysses", "ring-flash", "ring-zero1"]
# the JAX test's bound for ZeRO-1 against plain SP (test_seq_axis_composes_with_zero1);
# the ring flash composition merges the same f32 partials in another order
PLAIN_RING_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def runs():
    return single_device_run(), run_ranks(seq_step_rank, 4, CASES, MODEL_KW, step_params(),
                                          step_batches(), timeout=120)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_dp_sp_steps_match_the_single_device_step(runs, i):
    single, ranks = runs
    assert_matches_single_device(ranks, i, single, str(CASES[i]))


@pytest.mark.parametrize("i", [2, 3], ids=IDS[2:])
def test_they_are_the_plain_ring(runs, i):
    _, ranks = runs
    plain = ranks[0][0]
    np.testing.assert_allclose(ranks[0][i]["losses"], plain["losses"], rtol=1e-5)
    assert_params(ranks[0][i]["params"], plain["params"], PLAIN_RING_TOL, str(CASES[i]))


def test_zero1_means_over_seq_then_shards_over_data(runs):
    """ZeRO-1 means the gradients over the seq axis, reduce-scatters them
    over the data axis and all-gathers the parameters there: no gradient
    all-reduce over the data axis."""
    _, ranks = runs
    counts = ranks[0][3]["counts"]
    assert counts["comm.all_reduce.grad_seq"] == 3
    assert counts["comm.reduce_scatter.grad"] == counts["comm.all_gather.params"] == 3
    assert "comm.all_reduce.grad" not in counts


_ONE = dict(seq_axis=AxisGroup("seq", 1, 0))
REFUSALS = (
    (dict(seq_axis=AxisGroup("seq", 1, 0), shard_weight_update=True), "needs axis="),
    (dict(_ONE, grad_compression="int8"),
     "grad_compression='int8' is scoped to the plain data-parallel"),
    (dict(_ONE, grad_compression="int8_ef"),
     "grad_compression='int8_ef' is scoped to the plain data-parallel"),
    (dict(_ONE, sp_mode="tree"), "sp_mode must be 'ring' or 'ulysses'"),
    (dict(seq_axis=AxisGroup("seq", 1, 0), ep_axis="expert"),
     "ep_axis is incompatible with shard_weight_update / seq_axis"),
    (dict(seq_axis=AxisGroup("seq", 1, 0), pp_axis="pipe"),
     "pp_axis is incompatible with shard_weight_update / seq_axis"),
)


@pytest.mark.parametrize("kw,match", REFUSALS,
                         ids=["no-data-axis", "int8", "int8_ef", "sp_mode", "ep", "pp"])
def test_the_step_refuses_what_jax_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        step.make_train_step(optim.SGD(), **kw)
