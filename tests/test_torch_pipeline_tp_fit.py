"""``Trainer.fit`` under ``--pp 2 --tp 2`` (4 gloo ranks, ``[data, pipe,
model] = [1, 2, 2]``: each stage's blocks in Megatron shards) held against
the JAX ``Trainer`` on the same mesh, with eval, from the same initial
weights on unaugmented batches, and its ranks' static memory ledgers."""

import jax
import numpy as np
import pytest
from model_parallel_jax import FIT_RUN, assert_fit_matches, jax_fit
from torch_ranks import mp_fit_rank, run_ranks

RUN = dict(FIT_RUN, model="vit_pp_tiny", pp=2, tp=2)


@pytest.fixture(scope="module")
def fits():
    params, jax_epochs = jax_fit(RUN, [1, 2, 2], ["data", "pipe", "model"])
    ranks = run_ranks(mp_fit_rank, 4, [dict(RUN, device="cpu")], params, timeout=120)
    return jax_epochs, params, [r[0] for r in ranks]


def test_the_pp_tp_trainer_matches_the_jax_trainer(fits):
    jax_epochs, _, ranks = fits
    for r in ranks:
        assert r["n_data"] == 1 and r["batches"] == (16, 16)
    assert_fit_matches(jax_epochs, ranks)


def test_a_pp_tp_ledger_counts_a_ranks_rows_and_shards(fits):
    """Each rank holds half the depth's rows of the 12 stacked block leaves,
    its qkv/mlp1 and proj/mlp2 weights (and the column biases) halved again:
    its bytes a device are its own parameters'; the gathered final weights
    are the same on every rank."""
    _, params, ranks = fits
    n_full = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    for r in ranks:
        sec = r["ledger"]
        assert sec["sharded_leaves"] == 12 and sec["bytes_total"] == n_full * 4
        assert sec["bytes_per_device"] == r["local_numel"] * 4 < sec["bytes_total"]
    for r in ranks[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(r["final"]),
                        jax.tree_util.tree_leaves(ranks[0]["final"])):
            np.testing.assert_array_equal(a, b)
