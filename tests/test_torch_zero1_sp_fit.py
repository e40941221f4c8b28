"""``Trainer.fit --sp 2 --shard_weight_update`` in the port on 4 gloo ranks
(a ``[data=2, seq=2]`` mesh): the losses against the JAX ``Trainer`` of the
same config on a ``[2, 2]`` CPU mesh (unaugmented inputs, as
``test_torch_seq_parallel_fit.py``), a resume bit for bit in both checkpoint
formats (plain; sharded and async), each format's checkpoint read by the
JAX package's restore as the fit's final state, and an elastic resume on 2
ranks at a
data extent of 1, whose re-laid flat state must be the JAX package's remap
of the same checkpoint.
"""

import os

import pytest
from seq_parallel_jax import FIT_RUN, assert_fit_matches, jax_fit
from torch_ranks import ladder_rank, ladders_rank, run_ranks, seq_fit_rank
from zero1_sp_jax import assert_flat_equal, jax_restore, params_len

from tpu_dist_torch.comm.quantize import padded_len

ZERO1 = dict(FIT_RUN, shard_weight_update=True, device="cpu", save_every=1)
FORMATS = {"plain": {}, "sharded-async": {"sharded_ckpt": True, "async_ckpt": True}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero1_sp_fit")
    params, jax_epochs = jax_fit("ring", shard_weight_update=True)
    cfgs = [dict(ZERO1, ckpt_dir=str(root / name), **kw) for name, kw in FORMATS.items()]
    fits = run_ranks(seq_fit_rank, 4, cfgs, params, timeout=120)
    resumed = run_ranks(ladders_rank, 4, [dict(cfg, resume=True, epochs=3) for cfg in cfgs],
                        timeout=120)
    elastic = run_ranks(ladder_rank, 2, dict(cfgs[0], resume=True, epochs=3), timeout=120)
    return jax_epochs, fits, resumed, elastic, cfgs


def test_fit_matches_the_jax_trainer(runs):
    jax_epochs, fits, *_ = runs
    for i in range(len(FORMATS)):
        assert_fit_matches(jax_epochs, [f[i] for f in fits])


@pytest.mark.parametrize("i", range(len(FORMATS)), ids=list(FORMATS))
def test_a_resume_is_bit_for_bit(runs, i):
    _, fits, resumed, _, _ = runs
    final = fits[0][i]["state"]
    for r, ladders in enumerate(resumed):
        start, step, state = ladders[i]
        assert (start, step) == (2, 4), r
        assert_flat_equal(state, final, f"resumed on rank {r}")
        assert_flat_equal(fits[r][i]["state"], final, f"rank {r}'s final state")


@pytest.mark.parametrize("i", range(len(FORMATS)), ids=list(FORMATS))
def test_the_trainer_s_checkpoints_restore_in_jax(runs, i):
    """The last epoch's checkpoint of each format, read by the JAX
    package's ``restore``/``restore_sharded`` on a ``[2, 2]`` CPU mesh, is
    the fit's final state bit for bit."""
    _, fits, _, _, cfgs = runs
    name = "ckpt_1.npz" if list(FORMATS)[i] == "plain" else "ckpt_1.manifest.json"
    got = jax_restore(os.path.join(cfgs[i]["ckpt_dir"], name), "SGD", n_data=2)
    assert_flat_equal(got, fits[0][i]["state"], f"JAX restore of the {list(FORMATS)[i]} save")


def test_an_elastic_resume_at_another_data_extent_is_jax_s_remap(runs):
    """2 ranks at sp 2: a data extent of 1, the flat momentum re-laid from
    2 data ranks' padding to 1's, as JAX's remapper re-lays it."""
    _, fits, _, elastic, cfgs = runs
    path = os.path.join(cfgs[0]["ckpt_dir"], "ckpt_1.npz")
    want = jax_restore(path, "SGD", n_data=1)
    for r, (start, step, state) in enumerate(elastic):
        assert (start, step) == (2, 4), r
        assert_flat_equal(state, want, f"elastic resume on rank {r}")
    # the data extent of 1 pads nothing; the 2 ranks' layout padded to even
    assert want["['opt_state']"].size == params_len()
    assert fits[0][0]["state"]["['opt_state']"].size == padded_len(params_len(), 2)
