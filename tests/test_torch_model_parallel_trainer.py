"""``Trainer.fit`` under ``--tp 2`` (2 gloo ranks, ``[data, model] = [1,
2]``) held against the JAX ``Trainer`` on the same mesh: the same initial
weights, the same unaugmented batches, 2 epochs of 2 steps with an eval
each; and the static memory ledger of a ``--tp 2`` rank, whose parameter
bytes a device are its shards'. ``--sp 2 --tp 2`` is
``test_torch_model_parallel_fit.py``, ``--ep 2 --moe_top_k 2``
``test_torch_expert_parallel_trainer.py``."""

import pytest
from model_parallel_jax import FIT_RUN, check_tp_fit, check_tp_ledger, jax_fit
from torch_ranks import mp_fit_rank, run_ranks

RUN = dict(FIT_RUN, model="vit_tiny", tp=2)


@pytest.fixture(scope="module")
def fits():
    params, jax_epochs = jax_fit(RUN, [1, 2], ["data", "model"])
    ranks = run_ranks(mp_fit_rank, 2, [dict(RUN, device="cpu")], params, timeout=120)
    return jax_epochs, [r[0] for r in ranks]


def test_the_tp_trainer_matches_the_jax_trainer(fits):
    check_tp_fit(*fits)


def test_a_tp_ledger_counts_the_shards_bytes_a_device(fits):
    check_tp_ledger(fits[1])
