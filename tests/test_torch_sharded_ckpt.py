"""The sharded checkpoint format in the port (``ckpt/checkpoint.py::
save_sharded`` and its kin), mirroring ``tests/test_sharded_ckpt.py``: per
rank shard files and a rank-0 manifest committed last, no gather at save
time, the uncommit before an overwrite, the prune of old and orphaned
shards, an incomplete checkpoint invisible and refused, the property round
trip; then the checkpoints across the two packages, both ways, for the
layouts of ``tests/fsdp_jax.py`` (plain DP, FSDP, ZeRO-1 through the
elastic remapper, TP): a save by 2 gloo ranks of the port read by the JAX
``restore_sharded`` on the 8 CPU devices, and a JAX save read by 2 and 4
port ranks. The arrays must be equal bit for bit, and the file names, the
manifest and the piece keys JAX's."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from fsdp_jax import (KINDS, assert_flat_equal, global_flat, jax_restore, jax_save, relaid)
from hypothesis import given, settings, strategies as st
from torch_ranks import layout_state, run_ranks, sharded_cross_rank

from tpu_dist.ckpt import checkpoint as jax_ckpt
from tpu_dist_torch import bridge, ckpt
from tpu_dist_torch.nn.vit import ViT
from tpu_dist_torch.parallel import fsdp
from tpu_dist_torch.train import step as step_lib
from tpu_dist_torch.train.optim import SGD
from tpu_dist_torch.train.state import TrainState


def _fsdp_like_state(seed=0, n=4, min_size=64):
    """A ViT's parameters and momentum sharded over a lockstep group of
    ``n`` virtual ranks (one process holds them all, as one JAX process
    holds its 8 devices), the momentum random."""
    opt = SGD()
    model = ViT(image_size=16, patch_size=8, dim=32, depth=1, heads=2, num_classes=10,
                device="cpu", seed=seed)
    s = fsdp.shard_state(TrainState.create(model, opt), lockstep=n, optimizer=opt,
                         min_size=min_size)
    rng = np.random.default_rng(seed)
    for b in s.opt_state:
        b.copy_(torch.from_numpy(rng.standard_normal(b.shape).astype(np.float32)))
    return s


def test_sharded_roundtrip_and_no_duplication(tmp_path):
    state = _fsdp_like_state()
    mpath = ckpt.save_sharded(str(tmp_path), state, 3, extra_meta={"pp": 1})
    assert mpath and mpath.endswith("ckpt_3.manifest.json")
    assert ckpt.latest_sharded_checkpoint(str(tmp_path)) == (mpath, 3)
    assert ckpt.read_sharded_meta(mpath)["pp"] == 1
    # one process -> one shard file, each distinct piece once: its
    # elements are the state's
    names = [n for n in os.listdir(tmp_path) if ".shard" in n]
    assert names == ["ckpt_3.shard0of1.npz"]
    with np.load(tmp_path / names[0]) as z:
        stored = sum(int(np.prod(z[k].shape)) for k in z.files if k != "__crc__")
        keys = [k for k in z.files if k != "__crc__"]
    flat = bridge.train_state_to_flat(state)
    assert stored == sum(int(np.prod(v.shape)) for v in flat.values())
    # JAX's piece keys: keystr|starts|sizes; the sharded leaves in 4 pieces
    qkv = sorted(k for k in keys if k.startswith("['params']['blocks'][0]['qkv']['w']"))
    assert qkv == [f"['params']['blocks'][0]['qkv']['w']|0,{24 * r}|32,24" for r in range(4)]
    assert "['step']||" in keys
    restored = ckpt.restore_sharded(mpath, _fsdp_like_state(seed=1, n=2))
    back = bridge.train_state_to_flat(restored)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    with open(mpath) as f:
        manifest = json.load(f)
    assert set(manifest) == {"meta", "n_shards", "shapes"} and manifest["n_shards"] == 1
    assert manifest["shapes"] == {k: list(v.shape) for k, v in flat.items()}


def test_sharded_pruning_uncommits_manifest_first(tmp_path):
    state = _fsdp_like_state()
    for e in range(4):
        ckpt.save_sharded(str(tmp_path), state, e, keep_last=2)
    names = sorted(os.listdir(tmp_path))
    assert "ckpt_3.manifest.json" in names and "ckpt_2.manifest.json" in names
    assert not any(n.startswith(("ckpt_0.", "ckpt_1.")) for n in names), names


def test_sharded_incomplete_is_invisible_and_refused(tmp_path):
    mpath = ckpt.save_sharded(str(tmp_path), _fsdp_like_state(), 0)
    os.rename(mpath, str(tmp_path / "stash.json"))  # no manifest: invisible
    assert ckpt.latest_sharded_checkpoint(str(tmp_path)) is None
    man = json.load(open(tmp_path / "stash.json"))
    man["n_shards"] = 2  # more shards than exist: a loud refusal
    with open(tmp_path / "ckpt_0.manifest.json", "w") as f:
        json.dump(man, f)
    with pytest.raises(FileNotFoundError, match="2 shard files"):
        ckpt.restore_sharded(str(tmp_path / "ckpt_0.manifest.json"), _fsdp_like_state())
    with pytest.raises(ckpt.CheckpointCorruptError, match="expects 2 shard files"):
        ckpt.verify_sharded(str(tmp_path / "ckpt_0.manifest.json"))


def test_a_piece_missing_is_corruption_and_a_missing_ef_is_zeros(tmp_path):
    state = _fsdp_like_state()
    mpath = ckpt.save_sharded(str(tmp_path), state, 0)
    shard = tmp_path / "ckpt_0.shard0of1.npz"
    with np.load(shard) as z:
        kept = {k: z[k] for k in z.files if not k.startswith(
            "['params']['blocks'][0]['qkv']['w']|0,24")}
    np.savez(shard, **kept)
    with pytest.raises(ckpt.CheckpointCorruptError, match="does not cover"):
        ckpt.restore_sharded(mpath, _fsdp_like_state(seed=1))
    with pytest.raises(ckpt.CheckpointCorruptError, match="stamped entries missing"):
        ckpt.verify_sharded(mpath, deep=False)
    # a checkpoint without residuals restores an int8_ef state's as zeros
    dp = layout_state("dp")
    mpath = ckpt.save_sharded(str(tmp_path / "dp"), dp, 0)
    ef_state = layout_state("dp", seed=7)
    lay = step_lib.flat_layout(ef_state.params)
    ef = {k: v.fill_(1.0) for k, v in step_lib.init_ef_state(ef_state.params, layout=lay).items()}
    ef_state = ckpt.restore_sharded(mpath, dataclasses.replace(ef_state, ef=ef, layout=lay))
    assert all(not v.any() for v in ef_state.ef.values())
    want = bridge.train_state_to_flat(dp)
    back = bridge.train_state_to_flat(ef_state)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_best_save_uncommits_before_overwrite(tmp_path):
    s = _fsdp_like_state()
    ckpt.ShardedCheckpointer.save_best(str(tmp_path), s, 3, 71.5)
    meta = ckpt.read_sharded_meta(str(tmp_path / "ckpt_best.manifest.json"))
    assert meta["metric"] == 71.5 and meta["epoch"] == 3
    ckpt.ShardedCheckpointer.save_best(str(tmp_path), s, 7, 82.0)
    meta = ckpt.read_sharded_meta(str(tmp_path / "ckpt_best.manifest.json"))
    assert meta["metric"] == 82.0 and meta["epoch"] == 7


def test_pruning_sweeps_orphaned_shards_and_keeps_quarantined(tmp_path):
    s = _fsdp_like_state()
    ckpt.save_sharded(str(tmp_path), s, 0)
    os.remove(tmp_path / "ckpt_0.manifest.json")  # a crashed epoch-0 save
    ckpt.save_sharded(str(tmp_path), s, 1)
    ckpt.quarantine(str(tmp_path / "ckpt_1.manifest.json"))
    for e in (2, 3, 4):
        ckpt.save_sharded(str(tmp_path), s, e, keep_last=2)
    names = os.listdir(tmp_path)
    assert not any(n.startswith(("ckpt_0.", "ckpt_2.")) for n in names), names
    assert "ckpt_1.manifest.json.corrupt" in names
    assert any(n.startswith("ckpt_3.") for n in names)


@settings(max_examples=25, deadline=None)
@given(dim=st.sampled_from([8, 12, 16, 24]), n=st.sampled_from([1, 2, 4]),
       min_size=st.sampled_from([1, 64, 1024]), seed=st.integers(0, 100))
def test_sharded_roundtrip_property(tmp_path_factory, dim, n, min_size, seed):
    """Any width and FSDP extent round-trips bit for bit through the piece
    format, and restores onto another extent."""
    d = str(tmp_path_factory.mktemp("shards"))
    opt = SGD()

    def make(s, k):
        model = ViT(image_size=8, patch_size=4, dim=dim, depth=1, heads=2, num_classes=3,
                    device="cpu", seed=s)
        return fsdp.shard_state(TrainState.create(model, opt), lockstep=k, optimizer=opt,
                                min_size=min_size)

    state = make(seed, n)
    mpath = ckpt.save_sharded(d, state, 0)
    want = bridge.train_state_to_flat(state)
    for k in (n, 4 // n):
        back = bridge.train_state_to_flat(ckpt.restore_sharded(mpath, make(seed + 1, k)))
        for key in want:
            np.testing.assert_array_equal(back[key], want[key], err_msg=key)


# -- across the two packages -----------------------------------------------------


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """JAX saves of every layout; the port's restores of them at 2 and 4
    ranks; the port's saves at 2 ranks, and their JAX restores."""
    root = tmp_path_factory.mktemp("cross")
    flats = {k: global_flat(k) for k in KINDS}
    mpaths = {k: jax_save(k, str(root / "jax" / k), flats[k]) for k in KINDS}
    port2 = run_ranks(sharded_cross_rank, 2, mpaths, str(root / "port"),
                      {k: relaid(flats[k], k, 2) for k in KINDS}, timeout=120)[0]
    port4 = run_ranks(sharded_cross_rank, 4, mpaths, None, None, timeout=120)[0]
    back = {k: jax_restore(k, str(root / "port" / k / "ckpt_0.manifest.json")) for k in KINDS}
    return flats, port2, port4, back, root


@pytest.mark.parametrize("kind", KINDS)
def test_a_jax_save_restores_in_the_port_at_2_and_4_ranks(cross, kind):
    flats, port2, port4, _, _ = cross
    assert_flat_equal(port2[kind], flats[kind], kind, "2 port ranks")
    assert_flat_equal(port4[kind], flats[kind], kind, "4 port ranks")


@pytest.mark.parametrize("kind", KINDS)
def test_a_port_save_restores_in_jax_on_8_devices(cross, kind):
    flats, _, _, back, root = cross
    assert_flat_equal(back[kind], flats[kind], kind, "JAX restore")
    d = root / "port" / kind
    assert sorted(os.listdir(d)) == ["ckpt_0.manifest.json", "ckpt_0.shard0of2.npz",
                                     "ckpt_0.shard1of2.npz"]
    assert jax_ckpt.verify_sharded(str(d / "ckpt_0.manifest.json"))["epoch"] == 0
    with open(d / "ckpt_0.manifest.json") as f:
        manifest = json.load(f)
    want = {k: list(np.shape(v)) for k, v in relaid(flats[kind], kind, 2).items()}
    assert manifest["n_shards"] == 2 and manifest["shapes"] == want
    # every piece key parses as JAX's and lies inside its leaf
    for name in ("ckpt_0.shard0of2.npz", "ckpt_0.shard1of2.npz"):
        with np.load(d / name) as z:
            for skey in z.files:
                if skey == "__crc__":
                    continue
                key, origin, extent = jax_ckpt._parse_shard_key(skey)
                assert tuple(z[skey].shape) == extent and len(origin) == len(want[key])
                assert all(o + e <= g for o, e, g in zip(origin, extent, want[key]))


def test_fsdp_pieces_are_each_ranks_window(cross):
    """An FSDP save writes each rank's own window of a sharded leaf (JAX's
    replica_id == 0 over the data axis), the replicated leaves once."""
    root = cross[4]
    pieces = {}
    for r in range(2):
        with np.load(root / "port" / "fsdp" / f"ckpt_0.shard{r}of2.npz") as z:
            pieces[r] = [jax_ckpt._parse_shard_key(k) for k in z.files if k != "__crc__"]
    w = "['params']['stage4'][0]['conv2']['w']"
    # HWIO (3, 3, 64, 64): the tie of I and O goes to the leading, I
    for r in range(2):
        assert [p[1:] for p in pieces[r] if p[0] == w] == [((0, 0, 32 * r, 0), (3, 3, 32, 64))]
    assert not any(p[0] == "['step']" for p in pieces[1])
