"""The port's native input pipeline (``tpu_dist_torch/data/native.py`` over
its own build of ``tpu_dist_torch/csrc/pipeline.cpp``) held against the JAX
package's (``tpu_dist/data/native.py`` over ``tpu_dist/csrc``'s library).

* The C++ source is the JAX package's byte for byte, and the port loads
  the library it built in its own tree.
* Its batches equal the JAX library's bit for bit: train (random crops)
  and eval, over several seeds, index sets and normalisation statistics.
* With nothing pinned, the port's ``Trainer`` and the JAX ``Trainer`` read
  the same first train and eval batches: both take the C++ pipeline.
* A library that cannot be built is no silent fallback: the reason is in
  ``describe()``, the trainer's ``input_pipeline`` and its warning line.
"""

import os

import jax
import numpy as np
import pytest

import tpu_dist.data.native as jax_native
from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.data import transforms as jax_transforms
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.data import native, transforms
from tpu_dist_torch.ops import _build
from tpu_dist_torch.train import trainer
from tests.helpers import TinyMLP
from torch_ranks import free_port, narrow_resnet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(n=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def test_the_source_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(ROOT, "tpu_dist", "csrc", "pipeline.cpp"), "rb") as f:
        theirs = f.read()
    assert (_build.CSRC / "pipeline.cpp").read_bytes() == theirs


def test_the_port_loads_its_own_build():
    assert native.available(), native.describe()
    path = native._PIPELINE.path
    assert path == str(_build.host_library_path("pipeline"))
    assert os.path.dirname(path) == str(_build.BUILD_DIR)
    assert native.describe() == f"native ({os.path.basename(path)})"


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("seed", [0, 1, 2 ** 63 - 1, 123456789])
def test_batches_equal_the_jax_librarys_bit_for_bit(train, seed):
    assert jax_native.available(), "the JAX package's library must build for this comparison"
    images = _images()
    rng = np.random.default_rng(seed % 1000)
    for n, stats in ((16, {}), (33, dict(mean=jax_transforms.CIFAR10_MEAN,
                                         std=jax_transforms.CIFAR10_STD))):
        sel = rng.integers(0, len(images), n)  # repeats included
        ours = native.gather_augment(images, sel, seed=seed, train=train, **stats)
        theirs = jax_native.gather_augment(images, sel, seed=seed, train=train, **stats)
        assert ours.dtype == np.float32 and ours.shape == (n, 32, 32, 3)
        np.testing.assert_array_equal(ours, theirs)


def test_the_crops_differ_from_the_numpy_stream_but_not_the_windows():
    """The same function with another crop stream: every native crop is
    one of the numpy path's 81 windows of the same image."""
    images, sel = _images(), np.arange(8)
    ours = native.gather_augment(images, sel, seed=5, train=True)
    numpy_path = transforms.gather_augment(images, sel, seed=5, train=True)
    assert not np.array_equal(ours, numpy_path)
    padded = np.pad(images[sel], ((0, 0), (4, 4), (4, 4), (0, 0)))
    for i in range(len(sel)):
        windows = [transforms.gather_augment(padded[i:i + 1, y:y + 32, x:x + 32], [0], seed=0,
                                             train=False)
                   for y in range(9) for x in range(9)]
        assert any(np.allclose(ours[i], w, atol=1e-5) for w in windows), i


def test_bad_inputs_raise_before_the_library_reads_them():
    images = _images(8)
    with pytest.raises(IndexError):
        native.gather_augment(images, [0, 8], seed=0, train=True)
    with pytest.raises(IndexError):
        native.gather_augment(images, [-1], seed=0, train=True)
    with pytest.raises(ValueError, match="uint8"):
        native.gather_augment(images.astype(np.float32), [0], seed=0, train=True)


RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=96,
           batch_size=16, epochs=1, seed=3)


def test_both_trainers_read_the_same_first_batches():
    """The batches do not depend on the model: the JAX side builds a small
    MLP (its ResNet's initialisation compiles for ~20 s on the CPU)."""
    jax_trainer.register_model("pipeline_probe",
                               lambda num_classes: TinyMLP(num_classes, width=16, in_dim=3072))
    trainer.register_model("pipeline_probe", narrow_resnet)
    cfg = {**RUN, "model": "pipeline_probe"}
    jt = jax_trainer.Trainer(
        JaxConfig(**cfg), mesh=mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS], jax.devices()[:1]))
    pt = trainer.Trainer(TrainConfig(**cfg, device="cpu", port=free_port()))
    try:
        assert pt.input_pipeline.startswith("native")
        for jl, pl in ((jt.train_loader, pt.train_loader), (jt.test_loader, pt.test_loader)):
            jit, pit = iter(jl), iter(pl)
            theirs, ours = next(jit), next(pit)
            jit.close()
            pit.close()
            assert len(theirs) == len(ours)
            for a, b in zip(theirs, ours):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    finally:
        pt.close()


def test_a_failed_build_is_reported_not_silent(monkeypatch, capsys):
    monkeypatch.setattr(native, "_PIPELINE", native.Pipeline())
    monkeypatch.setenv("CXX", os.path.join(ROOT, "no-such-compiler"))
    assert not native.available()
    assert native.describe().startswith("numpy (FileNotFoundError: ")
    images, sel = _images(8), np.arange(4)
    np.testing.assert_array_equal(native.gather_augment(images, sel, seed=7, train=True),
                                  transforms.gather_augment(images, sel, seed=7, train=True))
    trainer.register_model("narrow_resnet", narrow_resnet)
    pt = trainer.Trainer(TrainConfig(**RUN, device="cpu", port=free_port()))
    pt.close()
    assert pt.input_pipeline == native.describe()
    assert f"=> WARNING: input pipeline: {native.describe()}" in capsys.readouterr().out
