"""``Trainer.fit`` under ``--pp 2`` (2 gloo ranks, ``[data, pipe] = [1,
2]``) held against the JAX ``Trainer`` on the same mesh, with eval, from
the same initial weights on unaugmented batches; the first step's
``device.flops_per_step`` is the same at pp 1 and 2 (the active ticks
only, the replicated layers once a pipe group); the ranks' static memory
ledgers. ``--pp_interleave 2``: ``test_torch_pipeline_interleaved_fit.py``."""

import pytest
from model_parallel_jax import FIT_RUN, assert_fit_matches, jax_fit
from torch_ranks import mp_fit_rank, run_ranks

RUN = dict(FIT_RUN, model="vit_pp_tiny", pp=2)
RUNS = {"pp2": RUN}


@pytest.fixture(scope="module")
def fits():
    jax_runs = {name: jax_fit(run, [1, 2], ["data", "pipe"]) for name, run in RUNS.items()}
    # the last config (pp 1: two data ranks of the whole model, its own
    # weights) only for the first step's count
    cfgs = [dict(run, device="cpu") for run in RUNS.values()] + [
        dict(RUN, pp=1, epochs=1, steps_per_epoch=1, eval_every=0, device="cpu")]
    ranks = run_ranks(mp_fit_rank, 2, cfgs, [p for p, _ in jax_runs.values()] + [None],
                      timeout=120)
    return jax_runs, ranks


@pytest.mark.parametrize("name", list(RUNS))
def test_the_pp_trainer_matches_the_jax_trainer(fits, name):
    jax_runs, ranks = fits
    mine = [r[list(RUNS).index(name)] for r in ranks]
    for r in mine:
        assert r["n_data"] == 1 and r["batches"] == (16, 16)
    assert_fit_matches(jax_runs[name][1], mine)


def test_flops_per_step_is_the_same_across_pp(fits):
    """The step's FLOPs over every rank: at pp 1 (two data ranks of the
    whole model) and at pp 2 (each stage's blocks on its active ticks, the
    embedding and the head counted once a pipe group) the same count,
    exactly."""
    _, ranks = fits
    for r in ranks:
        flops = [c["cost"]["flops_per_step"] for c in r]
        assert flops[0] == flops[1] > 0


def test_a_stages_ledger_holds_its_rows(fits):
    """vit_pp_tiny at pp 2: each rank's 12 stacked block leaves hold half
    the depth; its bytes a device are its own parameters'."""
    _, ranks = fits
    for r in ranks:
        for run in r[:1]:
            sec = run["ledger"]
            assert sec["sharded_leaves"] == 12
            assert sec["bytes_per_device"] == run["local_numel"] * 4 < sec["bytes_total"]
