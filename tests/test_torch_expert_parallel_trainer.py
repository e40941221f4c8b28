"""``Trainer.fit`` of ``vit_moe_tiny`` under ``--ep 2 --moe_top_k 2`` (2
gloo ranks, ``[data, expert] = [1, 2]``) held against the JAX ``Trainer``
on the same mesh: the same initial weights, the same unaugmented batches
(each expert rank its contiguous half of the data row's batch, as JAX
shards over ``(data, expert)``), 2 epochs of 2 steps with an eval each; and
the ledger's expert slabs, sharded."""

import pytest
from model_parallel_jax import FIT_RUN, assert_fit_matches, jax_fit
from torch_ranks import mp_fit_rank, run_ranks

RUN = dict(FIT_RUN, model="vit_moe_tiny", ep=2, moe_top_k=2)


@pytest.fixture(scope="module")
def fits():
    params, jax_epochs = jax_fit(RUN, [1, 2], ["data", "expert"])
    ranks = run_ranks(mp_fit_rank, 2, [dict(RUN, device="cpu")], params, timeout=120)
    return jax_epochs, [r[0] for r in ranks]


def test_the_ep_trainer_matches_the_jax_trainer(fits):
    """The data row's batch (16) a rank, 8 of it trained and evaluated by
    each expert rank; the losses (with 0.01 times the top-2 routers'
    load-balancing loss), the eval loss and the hits match JAX's."""
    jax_epochs, ranks = fits
    for r in ranks:
        assert r["n_data"] == 1 and r["batches"] == (16, 16)
    assert_fit_matches(jax_epochs, ranks)


def test_an_ep_ledger_counts_the_slabs_bytes_a_device(fits):
    """vit_moe_tiny at ep 2: each block's w_in and w_out slabs (2 blocks)
    are sharded, a device holding 4 of the 8 experts."""
    _, ranks = fits
    for r in ranks:
        sec = r["ledger"]
        assert sec["sharded_leaves"] == 4
        assert sec["bytes_per_device"] == r["local_numel"] * 4 < sec["bytes_total"]
