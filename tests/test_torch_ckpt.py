"""The port's checkpoint format and integrity layer
(``tpu_dist_torch/ckpt/checkpoint.py``, ``bridge.train_state_to_flat`` and
``bridge.load_train_state``) held against the JAX package's
``tpu_dist/ckpt/checkpoint.py``.

* Format, for a narrow ResNet and ``vit_tiny``: the port's flat dict has
  the keys, shapes, dtypes and values that ``tpu_dist.ckpt``'s
  ``_flatten`` (``jax.tree_util.keystr`` paths) gives the bridged JAX
  ``TrainState``; a file ``tpu_dist.ckpt.save`` wrote restores into the
  port's live state bit for bit, and a file the port wrote restores in
  ``tpu_dist.ckpt.restore`` against a JAX template bit for bit.
* Integrity: a flipped byte and a rewritten entry fail verification; the
  trainer's resume quarantines a corrupt newest file and falls back;
  ``sweep_stale_tmp``, ``keep_last`` pruning and ``retry_call``.
* Async: a save followed at once by two in-place steps publishes the
  state from before the steps.
"""

import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch
from torch_ranks import free_port, narrow_resnet

import tpu_dist.ckpt.checkpoint as jax_ckpt
from tpu_dist.train.state import TrainState as JaxTrainState
from tpu_dist_torch import bridge
from tpu_dist_torch import ckpt
from tpu_dist_torch.ckpt import checkpoint as port_ckpt
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.nn import resnet, vit
from tpu_dist_torch.resilience import retry
from tpu_dist_torch.train import optim, state as state_lib, step as step_lib, trainer

def _model(kind: str, seed: int):
    if kind == "resnet":
        return narrow_resnet(10, "cpu", seed)
    return vit.vit_tiny(device="cpu", seed=seed)


def _port_state(kind: str, seed: int, step: int = 0):
    """A port TrainState with random momentum and BN statistics, so no leaf
    is a constant."""
    model = _model(kind, seed)
    st = state_lib.TrainState.create(model, optim.SGD())
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for b in st.opt_state:
            b.copy_(torch.randn(b.shape, generator=gen))
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) + (0.5 if "var" in name else -0.5))
    st.step = step
    return st


def _jax_tree(st):
    """The bridged JAX ``TrainState`` of a port state (numpy leaves)."""
    model = st.params
    if isinstance(model, resnet.ResNet):
        params, bn = bridge.resnet_params_to_jax(model)
        mom = bridge.resnet_sgd_state_to_jax(model, st.opt_state)
    else:
        params, bn, mom = bridge.vit_params_to_jax(model), {}, bridge.sgd_state_to_jax(
            model, st.opt_state)
    return JaxTrainState(params=params, bn_state=bn, opt_state=mom, step=np.int32(st.step))


def _assert_flat_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


KINDS = ["resnet", "vit"]


@pytest.mark.parametrize("kind", KINDS)
def test_port_keys_and_arrays_are_the_jax_flatten(kind):
    st = _port_state(kind, 0, step=5)
    want = jax_ckpt._flatten(_jax_tree(st)._asdict())
    got = bridge.train_state_to_flat(st)
    _assert_flat_equal(got, want)
    assert got["['step']"].dtype == np.int32 and got["['step']"].shape == ()
    assert not any(k.startswith("['ef']") for k in got)
    assert any(k.startswith("['bn_state']") for k in got) == (kind == "resnet")


@pytest.mark.parametrize("kind", KINDS)
def test_a_jax_file_restores_into_the_port_bit_for_bit(kind, tmp_path):
    src = _jax_tree(_port_state(kind, 0, step=7))  # the JAX-side state to save
    path = jax_ckpt.save(str(tmp_path), src, 3, extra_meta={"pp": 1, "pp_interleave": 1})
    assert path == str(tmp_path / "ckpt_3.npz")
    live = _port_state(kind, 1)  # other weights, momentum and statistics
    params_before = [p.data_ptr() for p in live.params.parameters()]
    buffers_before = [b.data_ptr() for b in live.opt_state]
    restored = bridge.load_train_state(live, ckpt.restore(path, verify=True))
    assert restored.step == 7 and restored.params is live.params
    # copied in place: the live tensors keep their storage
    assert [p.data_ptr() for p in live.params.parameters()] == params_before
    assert [b.data_ptr() for b in restored.opt_state] == buffers_before
    _assert_flat_equal(bridge.train_state_to_flat(restored), jax_ckpt._flatten(src._asdict()))
    assert ckpt.read_meta(path)["epoch"] == 3


@pytest.mark.parametrize("kind", KINDS)
def test_a_port_file_restores_in_jax_bit_for_bit(kind, tmp_path):
    st = _port_state(kind, 2, step=11)
    path = ckpt.save(str(tmp_path), st, 4, extra_meta={"pp": 1, "pp_interleave": 1})
    template = jax.tree_util.tree_map(np.zeros_like, _jax_tree(_port_state(kind, 3)))
    got = jax_ckpt.restore(path, template, verify=True)
    _assert_flat_equal(jax_ckpt._flatten(got._asdict()), bridge.train_state_to_flat(st))
    assert int(got.step) == 11
    assert jax_ckpt.verify_npz(path)["epoch"] == 4


def test_restore_refuses_another_model_and_leaves_the_state_alone(tmp_path):
    path = ckpt.save(str(tmp_path), _port_state("resnet", 0), 0)
    other = resnet.ResNet("basic", (1, 1, 1, 1), 10, widths=(8, 16, 32, 32), device="cpu")
    st = state_lib.TrainState.create(other, optim.SGD())
    before = bridge.train_state_to_flat(st)
    with pytest.raises(ValueError, match="shape"):
        bridge.load_train_state(st, ckpt.restore(path))
    _assert_flat_equal(bridge.train_state_to_flat(st), before)


def _flip_byte(path):
    """Flip one byte in the middle of the largest entry's array data (a
    byte of a local header's size fields would go unread)."""
    with zipfile.ZipFile(path) as z:
        big = max(z.infolist(), key=lambda i: i.compress_size)
    offset = big.header_offset + big.compress_size // 2
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def test_a_flipped_byte_fails_verification(tmp_path):
    path = ckpt.save(str(tmp_path), _port_state("resnet", 0), 0)
    assert ckpt.verify_npz(path)["epoch"] == 0
    _flip_byte(path)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify_npz(path)
    with pytest.raises((ckpt.CheckpointCorruptError,) + ckpt.CKPT_READ_ERRORS):
        ckpt.restore(path, verify=True)


def test_a_rewritten_entry_fails_its_crc_stamp(tmp_path):
    """A well-formed archive whose entry no longer matches the CRC32 stamped
    in ``__meta__`` (silent corruption below the zip layer's own CRC)."""
    path = ckpt.save(str(tmp_path), _port_state("resnet", 0), 0)
    with np.load(path) as z:
        entries = {k: z[k] for k in z.files}
    key = "['params']['fc']['b']"
    entries[key] = entries[key] + np.float32(1.0)
    np.savez(path, **entries)
    with pytest.raises(ckpt.CheckpointCorruptError, match="CRC32 mismatch"):
        ckpt.verify_npz(path)
    with pytest.raises(ckpt.CheckpointCorruptError, match="CRC32 mismatch"):
        ckpt.restore(path, verify=True)
    assert np.array_equal(ckpt.restore(path)[key], entries[key])  # unverified read


def test_sweep_stale_tmp_removes_only_leaked_temporaries(tmp_path):
    for name in ("ckpt_3.npz.tmp", "ckpt_2.manifest.json.tmp", "ckpt_1.npz", "notes.tmp"):
        (tmp_path / name).write_bytes(b"x")
    assert sorted(ckpt.sweep_stale_tmp(str(tmp_path))) == ["ckpt_2.manifest.json.tmp",
                                                          "ckpt_3.npz.tmp"]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_1.npz", "notes.tmp"]
    assert ckpt.sweep_stale_tmp(str(tmp_path / "missing")) == []


def test_keep_last_prunes_to_the_newest(tmp_path):
    st = _port_state("vit", 0)
    for epoch in range(5):
        ckpt.save(str(tmp_path), st, epoch, keep_last=2)
    ckpt.save_best(str(tmp_path), st, 1, 50.0)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.npz", "ckpt_4.npz", "ckpt_best.npz"]
    assert ckpt.latest_checkpoint(str(tmp_path)) == (str(tmp_path / "ckpt_4.npz"), 4)
    assert ckpt.read_meta(str(tmp_path / "ckpt_best.npz"))["metric"] == 50.0


def test_quarantine_takes_a_file_off_the_ladder(tmp_path):
    st = _port_state("vit", 0)
    paths = [ckpt.save(str(tmp_path), st, e) for e in range(2)]
    assert [e for _, e in ckpt.all_checkpoints(str(tmp_path))] == [1, 0]
    assert ckpt.quarantine(paths[1]).endswith("ckpt_1.npz.corrupt")
    ckpt.save(str(tmp_path), st, 1)
    assert ckpt.quarantine(paths[1]).endswith("ckpt_1.npz.corrupt.1")
    assert [e for _, e in ckpt.all_checkpoints(str(tmp_path))] == [0]


def test_retry_call_retries_a_transient_oserror():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    assert retry.retry_call(flaky, retries=2, sleep=slept.append) == "done"
    assert len(calls) == 3 and tuple(slept) == retry.backoff_delays(2) == (0.05, 0.1)
    calls.clear()
    with pytest.raises(OSError):
        retry.retry_call(flaky, retries=1, sleep=slept.append)
    assert retry.backoff_delays(4, base_delay=1.0, max_delay=3.0) == (1.0, 2.0, 3.0, 3.0)


def test_a_checkpoint_write_retries_a_transient_failure(tmp_path, monkeypatch):
    real, failures = os.replace, []

    def replace(src, dst):
        if not failures:
            failures.append(src)
            raise OSError("transient rename failure")
        return real(src, dst)

    monkeypatch.setattr(port_ckpt.os, "replace", replace)
    prev = ckpt.set_io_retries(1)
    try:
        path = ckpt.save(str(tmp_path), _port_state("vit", 0), 0)
    finally:
        ckpt.set_io_retries(prev)
    assert failures and ckpt.verify_npz(path)["epoch"] == 0


def test_async_save_publishes_the_state_from_before_the_next_steps(tmp_path):
    """The snapshot is taken before ``save`` returns: two fused in-place
    steps right after it leave the published file unchanged."""
    torch.manual_seed(0)
    model = _model("resnet", 0)
    opt = optim.SGD(fused=True)
    st = state_lib.TrainState.create(model, opt)
    step = step_lib.make_train_step(opt)
    images = torch.randn(3, 8, 32, 32, 3)
    labels = torch.randint(0, 10, (3, 8))
    st, _ = step(st, images[0], labels[0], 0.1)
    before = bridge.train_state_to_flat(st)
    writer = ckpt.AsyncCheckpointer()
    path = writer.save(str(tmp_path), st, 0, extra_meta={"note": "async"})
    for i in (1, 2):
        st, _ = step(st, images[i], labels[i], 0.1)
    assert writer.close() is True
    _assert_flat_equal(ckpt.restore(path, verify=True), before)
    after = bridge.train_state_to_flat(st)
    assert not np.array_equal(after["['params']['fc']['w']"], before["['params']['fc']['w']"])
    assert ckpt.read_meta(path)["note"] == "async" and ckpt.read_meta(path)["step"] == 1


def test_async_writer_surfaces_a_write_error(tmp_path):
    writer = ckpt.AsyncCheckpointer()
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    writer.save(str(blocker / "sub"), _port_state("vit", 0), 0)
    with pytest.raises(OSError):
        writer.close()


NARROW_RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=64,
                  batch_size=16, epochs=2, steps_per_epoch=2, lr=0.02, log_every=1,
                  eval_every=0, seed=0, save_every=1, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _narrow_model():
    trainer.register_model("narrow_resnet", narrow_resnet)


def test_resume_quarantines_a_corrupt_newest_file_and_falls_back(tmp_path):
    d = str(tmp_path)
    t = trainer.Trainer(TrainConfig(**NARROW_RUN, port=free_port(), ckpt_dir=d))
    try:
        t.fit()
    finally:
        t.close()
    epoch0 = ckpt.restore(os.path.join(d, "ckpt_0.npz"), verify=True)
    _flip_byte(os.path.join(d, "ckpt_1.npz"))
    with open(os.path.join(d, "ckpt_2.npz.tmp"), "wb") as f:  # a torn write
        f.write(b"torn")
    t = trainer.Trainer(TrainConfig(**NARROW_RUN, port=free_port(), ckpt_dir=d, resume=True))
    try:
        assert t.start_epoch == 1 and t.state.step == 2
        _assert_flat_equal(bridge.train_state_to_flat(t.state), epoch0)
    finally:
        t.close()
    assert sorted(os.listdir(d)) == ["ckpt_0.npz", "ckpt_1.npz.corrupt"]


def test_resume_refuses_a_checkpoint_of_another_configuration(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, _port_state("resnet", 0), 0, extra_meta={"pp": 2, "pp_interleave": 2})
    with pytest.raises(ckpt.ConfigMismatchError, match="pp_interleave"):
        trainer.Trainer(TrainConfig(**NARROW_RUN, port=free_port(), ckpt_dir=d, resume=True))
    ckpt.save(d, _port_state("resnet", 0), 1, extra_meta={
        "elastic": ckpt.elastic_stamp(1, 1, 123)})
    with pytest.raises(ckpt.ConfigMismatchError, match="params_len=123"):
        trainer.Trainer(TrainConfig(**NARROW_RUN, port=free_port(), ckpt_dir=d, resume=True))
    assert sorted(os.listdir(d)) == ["ckpt_0.npz", "ckpt_1.npz"]  # nothing quarantined


def test_resume_of_a_sharded_checkpoint_dir_raises_the_format_mismatch(tmp_path):
    """A directory that holds only the other format raises the JAX
    trainer's loud ``ValueError`` both ways (the formats do not convert)."""
    (tmp_path / "ckpt_0.manifest.json").write_text(json.dumps({"epoch": 0}))
    with pytest.raises(ValueError, match="holds checkpoints in the sharded format") as info:
        trainer.Trainer(TrainConfig(**NARROW_RUN, port=free_port(), ckpt_dir=str(tmp_path),
                                    resume=True))
    assert "flip --sharded_ckpt to match" in str(info.value)
    plain = tmp_path / "plain"
    ckpt.save(str(plain), _port_state("resnet", 0), 0)
    with pytest.raises(ValueError, match="holds checkpoints in the plain format"):
        trainer.Trainer(TrainConfig(**NARROW_RUN, port=free_port(), ckpt_dir=str(plain),
                                    resume=True, sharded_ckpt=True))


def test_the_file_is_an_npz_with_a_crc_per_entry(tmp_path):
    st = _port_state("vit", 0, step=3)
    path = ckpt.save(str(tmp_path), st, 2, extra_meta={"lr_scale": 0.5})
    with zipfile.ZipFile(path) as z:
        names = [n.removesuffix(".npy") for n in z.namelist()]
    flat = bridge.train_state_to_flat(st)
    assert names == list(flat) + ["__meta__"]
    meta = ckpt.read_meta(path)
    assert (meta["epoch"], meta["step"], meta["lr_scale"]) == (2, 3, 0.5)
    assert meta["crc32"] == {k: jax_ckpt._entry_crc(v) for k, v in flat.items()}
