"""``Trainer.fit`` under ``--sp 2 --tp 2`` (4 gloo ranks, ``[data, model,
seq] = [1, 2, 2]``, ring attention over the local heads) held against the
JAX ``Trainer`` on the same mesh, and its ranks' static memory ledgers, as
``test_torch_model_parallel_trainer.py`` holds ``--tp 2``."""

import pytest
from model_parallel_jax import FIT_RUN, check_tp_fit, check_tp_ledger, jax_fit
from torch_ranks import mp_fit_rank, run_ranks

RUN = dict(FIT_RUN, model="vit_tiny", tp=2, sp=2)


@pytest.fixture(scope="module")
def fits():
    params, jax_epochs = jax_fit(RUN, [1, 2, 2], ["data", "model", "seq"])
    ranks = run_ranks(mp_fit_rank, 4, [dict(RUN, device="cpu")], params, timeout=120)
    return jax_epochs, [r[0] for r in ranks]


def test_the_sp_tp_trainer_matches_the_jax_trainer(fits):
    check_tp_fit(*fits, sp=2)


def test_an_sp_tp_ledger_counts_the_shards_bytes_a_device(fits):
    check_tp_ledger(fits[1])
