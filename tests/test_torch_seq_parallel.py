"""The port's sequence-parallel attention held against the JAX package's,
4-way: ``ring_attention`` and ``ulysses_attention`` on 4 gloo ranks
(``tests/torch_ranks.py::seq_attention_rank``) against the JAX functions
inside ``shard_map`` over a 4-device ``seq`` mesh
(``tests/seq_parallel_jax.py``), forward and gradients, causal and not; the
collectives each issues; and the refusals that need no ranks. The ring
flash composition is ``test_torch_ring_flash.py``.

The same inputs, drawn with numpy, go to both sides; gradients are those
of ``sum(out * ct)`` for one numpy cotangent ``ct``.
"""

import pytest
import torch
from seq_parallel_jax import N, assert_matches_jax, case_id, inputs
from torch_ranks import run_ranks, seq_attention_rank

from tpu_dist_torch.comm.mesh import AxisGroup
from tpu_dist_torch.nn import attention

CASES = (("ring", False, None), ("ring", True, None),
         ("ulysses", False, None), ("ulysses", True, None))


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(seq_attention_rank, N, CASES, *inputs(), timeout=120)


@pytest.mark.parametrize("i", range(len(CASES)), ids=[case_id(c) for c in CASES])
def test_matches_the_jax_function_forward_and_gradients(ranks, i):
    assert_matches_jax(ranks, CASES, i)


def test_the_ring_rotates_n_minus_one_times_and_ulysses_exchanges_twice(ranks):
    """Each forward of the ring sends the K/V blocks n - 1 times and its
    backward as many (the K/V gradients' cotangents back); Ulysses
    exchanges once out and once back each way."""
    counts = {CASES[i][:2]: ranks[0][i]["counts"] for i in range(len(CASES))}
    for causal in (False, True):
        assert counts[("ring", causal)] == {"comm.ppermute.ring_kv": N - 1,
                                            "comm.ppermute.ring_kv_grad": N - 1}
        assert counts[("ulysses", causal)] == {"comm.all_to_all.ulysses": 2,
                                               "comm.all_to_all.ulysses_grad": 2}


def test_ulysses_refuses_heads_that_do_not_divide():
    q = torch.zeros(1, 4, 3, 16)
    with pytest.raises(ValueError, match=r"heads \(3\) divisible by the axis size \(4\)"):
        attention.ulysses_attention(q, q, q, AxisGroup("seq", 4, 0))


def test_the_dispatch_refuses_an_unknown_sp_mode():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="sp_mode must be 'ring' or 'ulysses'"):
        attention.attention(q, q, q, seq=AxisGroup("seq", 1, 0), sp_mode="tree")
