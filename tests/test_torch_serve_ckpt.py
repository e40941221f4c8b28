"""Checkpoint -> serving weights (``tpu_dist_torch/serve/engine.py::
load_serving_state``) held against the JAX package's, both ways across the
packages: the cases of ``tests/test_serve.py``'s serving-restore tests run
through the port, and files written by one package load in the other.

Every comparison is bit for bit: a restore copies arrays, it computes
nothing.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
from torch_ranks import NARROW, narrow_resnet

from tpu_dist import ckpt as jax_ckpt_lib
from tpu_dist.nn import vit as jax_vit
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.obs import counters as jax_counters
from tpu_dist.serve import engine as jax_engine
from tpu_dist.serve.drill import _drill_model, write_training_ckpt
from tpu_dist.elastic.errors import ConfigMismatchError as JaxConfigMismatchError
from tpu_dist.train.state import TrainState as JaxTrainState
from tpu_dist_torch import bridge, ckpt
from tpu_dist_torch.comm.quantize import padded_len
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.elastic import ConfigMismatchError, Remapper, make_remapper, params_len
from tpu_dist_torch.nn import resnet, vit
from tpu_dist_torch.obs import counters
from tpu_dist_torch.serve import engine
from tpu_dist_torch.train import optim, state as state_lib, trainer


@pytest.fixture(autouse=True)
def _fresh_registries():
    counters.reset()
    jax_counters.reset()
    yield
    counters.reset()
    jax_counters.reset()


def _drill_twin():
    """The port's module of ``tpu_dist.serve.drill._drill_model``."""
    return resnet.ResNet("basic", (1, 1, 1, 1), 10, widths=(8, 8, 16, 16), device="cpu")


def _leaves(tree) -> dict:
    return bridge.keystr_flatten(jax.tree_util.tree_map(np.asarray, tree))


def _assert_trees_equal(ours, theirs):
    a, b = _leaves(ours), _leaves(theirs)
    assert list(a) == list(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_same_load(ours: dict, theirs: dict):
    assert _leaves(ours["params"])
    _assert_trees_equal(ours["params"], theirs["params"])
    _assert_trees_equal(ours["bn_state"], theirs["bn_state"])
    assert ours["remapped"] == theirs["remapped"]
    assert (ours["step"], ours["epoch"]) == (theirs["step"], theirs["epoch"])


@pytest.mark.parametrize("dp", [2, 4])
def test_a_jax_zero1_checkpoint_loads_in_the_port_through_the_remapper(tmp_path, dp):
    """``write_training_ckpt`` leaves what a ZeRO-1 run at ``dp`` leaves:
    one flat momentum vector of ``padded_len(L, dp)``. The port re-lays it
    at the serving extent through the remapper, as JAX does."""
    d = str(tmp_path / "ck")
    saved = write_training_ckpt(d, _drill_model(), dp=dp)
    theirs = jax_engine.load_serving_state(d, _drill_model())
    ours = engine.load_serving_state(d, _drill_twin())
    _assert_same_load(ours, theirs)
    # a length that dp divides already is the serving extent's length too
    relaid = padded_len(saved["L"], dp) != saved["L"]
    assert ours["remapped"] == ([("['opt_state']", "zero1_flat")] if relaid else [])
    assert relaid == (dp == 4)  # the drill model's L is even, not a multiple of 4
    _assert_trees_equal(ours["params"], saved["params"])
    _assert_trees_equal(ours["bn_state"], saved["bn_state"])
    assert ours["step"] == 120 and ours["epoch"] == 3 and ours["path"] == saved["path"]
    assert counters.get("serve.weights_loaded") == 1
    assert counters.get("serve.weights_remapped") == int(relaid)


def test_a_port_zero1_checkpoint_loads_in_both_packages(tmp_path):
    """The port's ``ckpt.save`` of a flat momentum vector (the layout a
    ZeRO-1 run at dp = 8 leaves, zero pad tail) loads in both packages
    with the same ``remapped`` pairs."""
    model = narrow_resnet(10, "cpu", 5)
    L = params_len(model)
    mom = torch.zeros(padded_len(L, 8))
    mom[:L] = torch.arange(1, L + 1, dtype=torch.float32) % 13 * 0.01
    st = state_lib.TrainState(params=model, bn_state=dict(model.named_buffers()),
                              opt_state=mom, step=9)
    d = str(tmp_path / "ck")
    ckpt.save(d, st, epoch=2, extra_meta={"elastic": ckpt.elastic_stamp(8, 8, L)})
    jax_model = ResNetDef(NARROW["block"], NARROW["stage_blocks"], 10, widths=NARROW["widths"])
    theirs = jax_engine.load_serving_state(d, jax_model)
    ours = engine.load_serving_state(d, narrow_resnet(10, "cpu", 0))
    _assert_same_load(ours, theirs)
    assert ours["remapped"] == [("['opt_state']", "zero1_flat")]
    params, bn = bridge.resnet_params_to_jax(model)
    _assert_trees_equal(ours["params"], params)
    _assert_trees_equal(ours["bn_state"], bn)


def test_a_checkpoint_of_the_port_trainer_loads_in_both_packages(tmp_path):
    """A file written by the port's ``Trainer`` (per-leaf momentum, the
    ``elastic`` stamp) serves through JAX's ``load_serving_state`` and the
    port's alike, nothing remapped, params and BN equal to the trainer's
    state bit for bit."""
    trainer.register_model("narrow_resnet", narrow_resnet)
    d = str(tmp_path / "ck")
    t = trainer.Trainer(TrainConfig(
        model="narrow_resnet", dataset="synthetic", synthetic_n=64, batch_size=16,
        epochs=1, steps_per_epoch=2, num_classes=10, device="cpu", ckpt_dir=d,
        save_every=1, seed=1))
    try:
        t.fit()
        params, bn = bridge.resnet_params_to_jax(t.state.params)
        step = int(t.state.step)
    finally:
        t.close()
    jax_model = ResNetDef(NARROW["block"], NARROW["stage_blocks"], 10, widths=NARROW["widths"])
    theirs = jax_engine.load_serving_state(d, jax_model)
    ours = engine.load_serving_state(d, narrow_resnet(10, "cpu", 0))
    _assert_same_load(ours, theirs)
    assert ours["remapped"] == [] and ours["step"] == step
    _assert_trees_equal(ours["params"], params)
    _assert_trees_equal(ours["bn_state"], bn)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_per_leaf_momentum_loads_verbatim(tmp_path, writer):
    """Plain SGD's per-leaf momentum needs no remap: the optimizer subtree
    is mirrored and nothing is rebuilt (``test_serve.py``'s case, with a
    ViT)."""
    model = vit.vit_tiny(device="cpu", seed=4)
    d = str(tmp_path / "ck")
    st = state_lib.TrainState.create(model, optim.SGD())
    with torch.no_grad():
        for b in st.opt_state:
            b.fill_(0.5)
    st.step = 7
    if writer == "port":
        ckpt.save(d, st, epoch=1)
    else:
        params = bridge.vit_params_to_jax(model)
        mom = bridge.sgd_state_to_jax(model, st.opt_state)
        jax_ckpt_lib.save(d, JaxTrainState(params=params, bn_state={}, opt_state=mom,
                                           step=np.asarray(7, np.int32)), epoch=1)
    theirs = jax_engine.load_serving_state(d, jax_vit.vit_tiny())
    ours = engine.load_serving_state(d, vit.vit_tiny(device="cpu", seed=0))
    _assert_same_load(ours, theirs)
    assert ours["remapped"] == [] and ours["bn_state"] == {}
    _assert_trees_equal(ours["params"], bridge.vit_params_to_jax(model))
    assert counters.get("serve.weights_remapped") == 0


def test_a_single_file_loads(tmp_path):
    saved = write_training_ckpt(str(tmp_path / "ck"), _drill_model(), dp=2)
    ours = engine.load_serving_state(saved["path"], _drill_twin())
    theirs = jax_engine.load_serving_state(saved["path"], _drill_model())
    _assert_same_load(ours, theirs)


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_a_corrupt_newest_file_is_quarantined(tmp_path, damage):
    """The ladder: a torn (truncated) or bit-flipped newest file is moved
    aside and the older one serves."""
    ckdir = str(tmp_path / "ck")
    saved = write_training_ckpt(ckdir, _drill_model(), dp=2)
    newest = os.path.join(ckdir, "ckpt_9.npz")
    shutil.copy(saved["path"], newest)
    size = os.path.getsize(newest)
    with open(newest, "r+b") as f:
        if damage == "truncate":
            f.truncate(size // 2)
        else:  # one byte in the middle of the largest entry's data
            import zipfile

            with zipfile.ZipFile(saved["path"]) as zf:
                info = max(zf.infolist(), key=lambda i: i.file_size)
            at = info.header_offset + 30 + len(info.filename) + info.file_size // 2
            f.seek(at)
            b = f.read(1)
            f.seek(at)
            f.write(bytes([b[0] ^ 0xFF]))
    ours = engine.load_serving_state(ckdir, _drill_twin())
    assert ours["epoch"] == 3 and ours["path"] == saved["path"]
    assert not os.path.exists(newest) and os.path.exists(newest + ".corrupt")
    assert counters.get("ckpt.quarantines") == 1
    _assert_trees_equal(ours["params"], saved["params"])


def test_a_lone_corrupt_file_raises(tmp_path):
    saved = write_training_ckpt(str(tmp_path / "ck"), _drill_model(), dp=2)
    with open(saved["path"], "r+b") as f:
        f.truncate(os.path.getsize(saved["path"]) // 2)
    with pytest.raises(Exception):
        engine.load_serving_state(saved["path"], _drill_twin())
    assert os.path.exists(saved["path"])  # a single file is never moved


@pytest.mark.parametrize("other", ["vit", "wider_resnet"])
def test_a_checkpoint_of_another_model_is_refused(tmp_path, other):
    d = str(tmp_path / "ck")
    write_training_ckpt(d, _drill_model(), dp=2)
    model = (vit.vit_tiny(device="cpu") if other == "vit"
             else narrow_resnet(10, "cpu", 0))
    with pytest.raises((ConfigMismatchError, KeyError)):
        engine.load_serving_state(d, model)
    with pytest.raises((JaxConfigMismatchError, KeyError)):
        jax_engine.load_serving_state(
            d, jax_vit.vit_tiny() if other == "vit" else ResNetDef(
                NARROW["block"], NARROW["stage_blocks"], 10, widths=NARROW["widths"]))


def test_a_directory_of_sharded_checkpoints_is_refused(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    (d / "ckpt_3.manifest.json").write_text("{}")
    with pytest.raises(ValueError, match="sharded"):
        engine.load_serving_state(str(d), _drill_twin())
    with pytest.raises(ValueError, match="sharded"):
        jax_engine.load_serving_state(str(d), _drill_model())
    with pytest.raises(FileNotFoundError):
        engine.load_serving_state(str(tmp_path), _drill_twin())


def test_the_remapper_refuses_a_nonzero_pad_tail_and_another_model():
    r = Remapper(L=5, n_new=1, n_old=4)
    out = r("['opt_state']", np.array([1, 2, 3, 4, 5, 0, 0, 0], np.float32), np.zeros(5))
    np.testing.assert_array_equal(out, [1, 2, 3, 4, 5])
    assert r.used == [("['opt_state']", "zero1_flat")]
    with pytest.raises(ConfigMismatchError, match="nonzero"):
        r("['opt_state']", np.arange(8, dtype=np.float32), np.zeros(5))
    with pytest.raises(ConfigMismatchError, match="params_len=6"):
        make_remapper({"w": np.zeros(5)}, {"elastic": {"params_len": 6}}, 1)
    assert r("['params']['w']", np.zeros(3), np.zeros(4)) is None


def test_one_config_mismatch_error_across_the_port():
    from tpu_dist_torch.ckpt import checkpoint

    assert ckpt.ConfigMismatchError is checkpoint.ConfigMismatchError is ConfigMismatchError
    assert ckpt.params_len is params_len
