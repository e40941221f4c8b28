"""The port's elastic resume (``tpu_dist_torch/train/trainer.py``): the
ports of ``tests/test_elastic.py``'s trainer tests, with the world shrunk
from 2 gloo ranks to 1 (the JAX tests shrink an 8-device mesh to 4 in one
process).

The narrow ResNet here has 9 classes, so it ravels to an odd number of
parameters (77,937): the ZeRO-1 flat vectors are padded at 2 ranks and
not at 1, and the shrink really re-lays them (the ``int8_ef`` residual's
row count changes with any world). Where the port and the JAX trainer
differ, the tests hold both behaviours:

* the process count changes here, so a mid-epoch snapshot re-enters
  through the consumed-example offset (the JAX tests keep one process and
  replay the step offset), on the interrupted world's own batches
  (``DataLoader.replay_world``), which the golden run took: the resumed
  trajectory differs from it by summation order alone;
* the offset epoch keeps the whole epoch's step numbers, so
  ``steps_per_epoch`` caps the epoch; the JAX trainer counts the rest of
  the epoch from 0.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
from torch_ranks import (elastic_and_ctrl_c_rank, elastic_fit_rank, free_port, narrow_resnet,
                         run_ranks)

from tpu_dist.ckpt import checkpoint as jax_ckpt
from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.data import DistributedSampler as JaxSampler
from tpu_dist.elastic.remap import elastic_stamp as jax_stamp
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch import ckpt
from tpu_dist_torch.comm.quantize import padded_len
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.data.sampler import DistributedSampler
from tpu_dist_torch.obs import counters
from tpu_dist_torch.resilience.preemption import PreemptedError
from tpu_dist_torch.train import trainer
from tests.helpers import TinyMLP

RUN = dict(model="narrow_resnet", num_classes=9, dataset="synthetic", synthetic_n=128,
           batch_size=32, epochs=2, steps_per_epoch=3, lr=0.02, log_every=50, eval_every=0,
           save_every=1, seed=0, device="cpu")
L = 77937
trainer.register_model("narrow_resnet", narrow_resnet)


def _cfg(**kw):
    return TrainConfig(**{**RUN, "port": free_port(), **kw})


def _npz(path):
    with np.load(path) as z:
        return {k: np.array(z[k]) for k in z.files if k != "__meta__"}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """At 2 ranks: a golden ZeRO-1 run, the same run SIGTERMed after step 1
    of epoch 1, and a ZeRO-1 + int8_ef run, each with its own ckpt_dir;
    then a ZeRO-1 + int8_ef run stopped by Ctrl-C in epoch 1, inside its
    step on rank 0 and after it on rank 1 (:func:`torch_ranks.ctrl_c_rank`)."""
    root = tmp_path_factory.mktemp("world2")
    runs = {"golden": dict(shard_weight_update=True),
            "preempt": dict(shard_weight_update=True, fault_plan="sigterm@epoch=1:step=1"),
            "ef": dict(shard_weight_update=True, grad_compression="int8_ef")}
    kws = [{**RUN, **kw, "ckpt_dir": str(root / name), "log_file": str(root / f"{name}.jsonl")}
           for name, kw in runs.items()]
    ctrl_c = {**RUN, **runs["ef"], "ckpt_dir": str(root / "ctrl_c")}
    out = run_ranks(elastic_and_ctrl_c_rank, 2, kws, ctrl_c, 4, timeout=180)
    return root, {**dict(zip(runs, out[0][0])), "ctrl_c": [o[1] for o in out]}


def test_ctrl_c_inside_one_ranks_step_skips_the_snapshot_on_every_rank(world2):
    """The emergency save of a flat layout gathers over the ranks, so the
    ranks agree first: rank 0 was inside its step (a half-done update),
    so rank 1, which was not, skips too instead of waiting in the gather.
    Both raise the interrupt, and the newest checkpoint stays epoch 0's."""
    _, runs = world2
    assert runs["ctrl_c"] == [("KeyboardInterrupt", ["ckpt_0.npz"])] * 2


def test_trainer_shrink_resume_zero1_ef_is_bit_exact(world2, tmp_path):
    root, runs = world2
    d = str(tmp_path / "ef")
    shutil.copytree(root / "ef", d)
    path, epoch = ckpt.latest_checkpoint(d)
    assert epoch == 1
    saved = _npz(path)
    assert ckpt.read_meta(path)["elastic"] == {"dp": 2, "procs": 2, "params_len": L}
    assert saved["['opt_state']"].shape == (padded_len(L, 2),)
    old_r1 = saved["['ef']['r1']"].reshape(2, padded_len(L, 2))
    log = str(tmp_path / "run.jsonl")
    t2 = trainer.Trainer(_cfg(shard_weight_update=True, grad_compression="int8_ef",
                              ckpt_dir=d, resume=True, log_file=log))
    try:
        assert t2.start_epoch == 2
        assert counters.get("resume.resharded") == 1
        from tpu_dist_torch import bridge
        now = bridge.train_state_to_flat(t2.state)
        for k in saved:
            if k.startswith("['params']") or k.startswith("['bn_state']"):
                np.testing.assert_array_equal(now[k], saved[k], err_msg=k)
        # ZeRO-1 momentum: the logical prefix bit for bit, no pad at 1 rank
        assert now["['opt_state']"].shape == (L,)
        np.testing.assert_array_equal(now["['opt_state']"], saved["['opt_state']"][:L])
        # the r1 residuals' total over the replicas, exactly
        np.testing.assert_array_equal(now["['ef']['r1']"],
                                      old_r1[:, :L].sum(axis=0, dtype=np.float32))
        last = t2.fit(3)  # ...and it trains an epoch at 1 rank
    finally:
        t2.close()
    assert np.isfinite(last["loss"]) and last["steps"] == 3
    resumes = [r for r in map(json.loads, open(log)) if r.get("kind") == "resume"]
    assert resumes and resumes[-1]["resharded"] is True
    assert (resumes[-1]["dp"], resumes[-1]["prev_dp"], resumes[-1]["prev_procs"]) == (1, 2, 2)
    assert counters.snapshot()["elastic.world_size"] == 1


def test_sigterm_midepoch_then_shrink_matches_golden(world2, tmp_path):
    root, runs = world2
    assert runs["preempt"]["last"] is None
    d = str(tmp_path / "elastic")
    shutil.copytree(root / "preempt", d)
    path, epoch = ckpt.latest_checkpoint(d)
    meta = ckpt.read_meta(path)
    assert epoch == 1 and meta["mid_epoch_step"] == 2
    assert meta["mid_epoch_examples"] == 2 * 32 and meta["mid_epoch_procs"] == 2
    saved = _npz(path)
    t2 = trainer.Trainer(_cfg(shard_weight_update=True, ckpt_dir=d, resume=True))
    try:
        # another process count: the offset path (JAX, at one process, replays step 2)
        assert t2.start_epoch == 1 and t2._resume_step == 0 and t2._resume_examples == 64
        from tpu_dist_torch import bridge
        now = bridge.train_state_to_flat(t2.state)
        for k in saved:
            if k.startswith("['params']"):
                np.testing.assert_array_equal(now[k], saved[k], err_msg=k)
        np.testing.assert_array_equal(now["['opt_state']"], saved["['opt_state']"][:L])
        last = t2.fit()
        final = bridge.train_state_to_flat(t2.state)
    finally:
        t2.close()
    golden = runs["golden"]
    # the same batches (the old world's, replayed) reduced over 1 rank
    # instead of 2: the JAX tests' golden-trajectory tolerance
    assert last["steps"] == 1  # epoch 1's third step, as the golden run's
    np.testing.assert_allclose(last["loss"], golden["last"]["loss"], rtol=2e-3)
    for k, v in golden["flat"].items():
        if k.startswith("['params']"):
            np.testing.assert_allclose(final[k], v, rtol=2e-3, atol=1e-5, err_msg=k)


def _save_offset_stamp(t, d, examples, procs):
    ckpt.save(d, t.state, epoch=0, extra_meta={
        "mid_epoch_step": 1, "mid_epoch_batch_size": 32, "mid_epoch_seed": 0,
        "mid_epoch_procs": procs, "mid_epoch_examples": examples,
        "elastic": ckpt.elastic_stamp(procs, procs, L)})


JAX_MLP = dict(dataset="synthetic", model="tiny_mlp_offset", num_classes=10, batch_size=32,
               epochs=1, log_every=50, eval_every=0, save_every=1, synthetic_n=128, seed=0,
               num_workers=1)


def _jax_offset_steps(d, steps_per_epoch):
    jax_trainer.register_model("tiny_mlp_offset",
                                lambda num_classes=10: TinyMLP(num_classes, width=4, in_dim=3072))
    cfg = JaxConfig(**JAX_MLP, steps_per_epoch=steps_per_epoch, ckpt_dir=d)
    mesh = mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS], jax.devices()[:1])
    t = jax_trainer.Trainer(cfg, mesh=mesh)
    params_len = sum(x.size for x in jax.tree_util.tree_leaves(t.state.params))
    jax_ckpt.save(d, t.state, epoch=0, extra_meta={
        "mid_epoch_step": 1, "mid_epoch_batch_size": 32, "mid_epoch_seed": 0,
        "mid_epoch_procs": 2, "mid_epoch_examples": 32,
        "elastic": jax_stamp(2, 2, params_len)})
    t2 = jax_trainer.Trainer(cfg.replace(resume=True), mesh=mesh)
    assert t2._resume_step == 0 and t2._resume_examples == 32
    return t2.fit()["steps"]


@pytest.mark.parametrize("steps_per_epoch", [None, 3])
def test_offset_resume_runs_only_the_remaining_examples(tmp_path, steps_per_epoch):
    """A snapshot stamped by another process count re-enters at the
    consumed-example offset: 128 examples, 32 consumed, so 3 of the 4
    global batches remain, and run. With ``steps_per_epoch`` 3 the port
    runs the epoch's steps 1 and 2; the JAX trainer counts the rest from 0
    and runs 3."""
    d = str(tmp_path / "port")
    t = trainer.Trainer(_cfg(epochs=1, steps_per_epoch=steps_per_epoch))
    _save_offset_stamp(t, d, 32, 2)
    t.close()
    t2 = trainer.Trainer(_cfg(epochs=1, steps_per_epoch=steps_per_epoch, ckpt_dir=d,
                              resume=True))
    try:
        assert t2.start_epoch == 0
        assert t2._resume_step == 0 and t2._resume_examples == 32
        last = t2.fit()
    finally:
        t2.close()
    assert last["steps"] == (3 if steps_per_epoch is None else 2)
    if steps_per_epoch is not None:  # the JAX trainer counts the rest from 0
        assert _jax_offset_steps(str(tmp_path / "jax"), steps_per_epoch) == 3
    # the end-of-epoch save is a clean one
    assert "mid_epoch_step" not in ckpt.read_meta(ckpt.latest_checkpoint(d)[0])


def test_mid_epoch_examples_stamp_clamps_to_dataset(tmp_path):
    """The last batch of a drop_last=False epoch is padded (4 steps of 64
    overshoot 200 examples): the stamp clamps to the dataset, and an offset
    at its end is an empty epoch, in both packages."""
    t = trainer.Trainer(_cfg(synthetic_n=200, batch_size=64))
    try:
        pos = t._mid_epoch_position(4)
    finally:
        t.close()
    assert pos["mid_epoch_examples"] == 200 and pos["mid_epoch_step"] == 4
    for sampler in (DistributedSampler(200, 1, 0), JaxSampler(200, 1, 0)):
        sampler.set_offset(200)
        assert len(sampler) == 0 and sampler.indices().size == 0


def test_a_one_rank_snapshot_grows_onto_two(tmp_path):
    """The reverse: a ZeRO-1 + int8_ef snapshot taken mid-epoch at 1 rank
    resumes at 2: the flat momentum is padded and split, the residual
    total lands in row 0 and row 1 starts at zero, the resume counts a
    grow, and each rank continues past the 64 consumed examples."""
    d = str(tmp_path / "one")
    t = trainer.Trainer(_cfg(shard_weight_update=True, grad_compression="int8_ef", ckpt_dir=d,
                             fault_plan="sigterm@epoch=1:step=1"))
    try:
        with pytest.raises(PreemptedError):
            t.fit()
    finally:
        t.close()
    path, _ = ckpt.latest_checkpoint(d)
    saved = _npz(path)
    assert ckpt.read_meta(path)["mid_epoch_procs"] == 1
    kw = {**RUN, "shard_weight_update": True, "grad_compression": "int8_ef", "ckpt_dir": d,
          "resume": True, "log_file": str(tmp_path / "grow.jsonl")}
    ranks = run_ranks(elastic_fit_rank, 2, [kw], timeout=120)
    for r in ranks:
        r = r[0]
        assert r["start_epoch"] == 1 and r["resume_examples"] == 64
        assert r["counters"]["resume.resharded"] == 1 and r["counters"]["elastic.grows"] == 1
        got = r["restored"]
        for k in saved:
            if k.startswith("['params']"):
                np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
        mom = got["['opt_state']"]
        assert mom.shape == (padded_len(L, 2),) and not mom[L:].any()
        np.testing.assert_array_equal(mom[:L], saved["['opt_state']"])
        r1 = got["['ef']['r1']"].reshape(2, padded_len(L, 2))
        np.testing.assert_array_equal(r1[0, :L], saved["['ef']['r1']"])
        assert not r1[1].any() and not r1[0, L:].any()
        assert np.isfinite(r["last"]["loss"]) and r["last"]["steps"] == 1
    resumes = [x for x in map(json.loads, open(kw["log_file"])) if x.get("kind") == "resume"]
    assert [(x["prev_dp"], x["dp"], x["examples_offset"], x["resharded"]) for x in resumes] == [
        (1, 2, 64, True)]


@pytest.mark.parametrize("old,new", [(2, 1), (1, 2), (4, 2), (2, 4)])
def test_the_replayed_epoch_is_the_old_worlds_batches(old, new):
    """After an offset of 2 global batches of 8, each step's global batch at
    the new world (its ranks' slices end to end) is the one the old world's
    ranks made at that step, their augmentation seeds included; together
    the steps cover the rest of the epoch's order once, nothing dropped or
    seen twice."""
    from tpu_dist_torch.data.loader import DataLoader

    n, g, offset = 40, 8, 16
    ids = np.arange(n).reshape(n, 1)

    def tag(images, sel, seed):  # the example and the crop seed it got
        return np.stack([images[sel, 0], np.full(len(sel), seed)], axis=1)

    def batches(world, replay=None):
        steps = []
        for rank in range(world):
            s = DistributedSampler(n, world, rank, shuffle=True, seed=3)
            s.set_epoch(1)
            loader = DataLoader(ids, np.zeros(n, np.int64), g // world, s,
                                gather_transform=tag, seed=5)
            if replay:
                s.set_offset(offset)
                loader.replay_world(replay)
            steps.append([b[0] for b in loader._host_batches()])
        return [np.concatenate(parts) for parts in zip(*steps)]

    before = batches(old)[offset // g:]
    after = batches(new, replay=old)
    assert len(after) == len(before) == (n - offset) // g
    for a, b in zip(after, before):
        np.testing.assert_array_equal(a, b)
    order = np.random.default_rng(3 + 1).permutation(n)
    assert sorted(np.concatenate(after)[:, 0]) == sorted(order[offset:])
