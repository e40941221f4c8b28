"""ZeRO-1 under the seq axis through both checkpoint formats, across the two
packages: 4 gloo ranks as a ``[data=2, seq=2]`` mesh hold ``vit_tiny``'s
flat optimizer state (SGD's momentum, AdamW's ``mu``/``nu``/``count``)
laid over the data axis (``step.axis_layout``), as the JAX package lays it
over ``n_data`` on a ``[2, 2]`` CPU mesh. Every seq index of a data row
holds the same shard, so a checkpoint gathers it over the data axis of seq
index 0 alone (``bridge._gathered_flat_parts``); a gather over every rank
would concatenate the two seq copies (4 chunks of the 2-rank layout, in
(data, seq) rank order). Checked: the gathered vector is the global one,
bit for bit; the port's plain, sync-sharded and async-sharded saves restore
in the port and in JAX's ``restore``/``restore_sharded`` on 4 CPU devices;
JAX's saves restore in the port; every restore leaf by leaf, bit for bit.
"""

import json
import os

import numpy as np
import pytest
from torch_ranks import run_ranks, zero1_sp_ckpt_rank
from zero1_sp_jax import (OPTS, assert_flat_equal, global_flat, jax_restore, jax_save,
                          params_len)

from tpu_dist.ckpt import checkpoint as jax_ckpt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero1_sp")
    flats = {o: global_flat(o) for o in OPTS}
    saves = {o: jax_save(flats[o], str(root / "jax" / o)) for o in OPTS}
    cases = [{"opt": o, "flat": flats[o], "jax": saves[o]} for o in OPTS]
    ranks = run_ranks(zero1_sp_ckpt_rank, 4, cases, str(root / "port"), timeout=120)
    return flats, ranks, root


@pytest.mark.parametrize("i", range(len(OPTS)), ids=OPTS)
def test_the_flat_state_lies_over_the_data_axis(runs, i):
    """Rank r sits at (data r // 2, seq r % 2): its layout is the data
    index's, over the 2 ranks of its seq index."""
    _, ranks, _ = runs
    for r, res in enumerate(ranks):
        world, index, lo = res[i]["layout"]
        assert (world, index) == (2, r // 2)
        assert lo == index * -(-params_len() // 2)
        assert res[i]["group"] == [r % 2, r % 2 + 2]


@pytest.mark.parametrize("i", range(len(OPTS)), ids=OPTS)
def test_the_gather_is_over_the_data_axis_of_seq_index_0(runs, i):
    """To rank 0: the global vectors bit for bit (a world gather gives
    twice their length); the other ranks return None. Without ``dst`` each
    data group gathers its own copy, the same on every rank."""
    flats, ranks, _ = runs
    flat = flats[OPTS[i]]
    assert_flat_equal(ranks[0][i]["dst0"], flat, "gathered to rank 0")
    assert all(res[i]["dst0"] is None for res in ranks[1:])
    for r, res in enumerate(ranks):
        assert_flat_equal(res[i]["all"], flat, f"all-gathered on rank {r}")


@pytest.mark.parametrize("fmt", ["plain", "sharded", "async"])
@pytest.mark.parametrize("i", range(len(OPTS)), ids=OPTS)
def test_a_port_save_restores_in_the_port_and_in_jax(runs, i, fmt):
    flats, ranks, root = runs
    opt, flat = OPTS[i], flats[OPTS[i]]
    assert_flat_equal(ranks[0][i][fmt], flat, f"port restore of the port's {fmt} save")
    path = ranks[0][i]["paths"][fmt]
    assert_flat_equal(jax_restore(path, opt), flat, f"JAX restore of the port's {fmt} save")
    if fmt != "plain":
        # one shard file a rank and the manifest, JAX's names; the flat
        # vectors whole in rank 0's file
        d = os.path.dirname(path)
        assert sorted(os.listdir(d)) == ["ckpt_0.manifest.json"] + [
            f"ckpt_0.shard{r}of4.npz" for r in range(4)]
        assert jax_ckpt.verify_sharded(path)["epoch"] == 0
        with open(path) as f:
            shapes = json.load(f)["shapes"]
        for key in flat:
            assert shapes[key] == list(np.shape(flat[key])), key


@pytest.mark.parametrize("fmt", ["plain", "sharded"])
@pytest.mark.parametrize("i", range(len(OPTS)), ids=OPTS)
def test_a_jax_save_restores_in_the_port(runs, i, fmt):
    flats, ranks, _ = runs
    assert_flat_equal(ranks[0][i]["jax_" + fmt], flats[OPTS[i]], f"port restore of JAX's {fmt}")
