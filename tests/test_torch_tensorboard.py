"""``--tensorboard_dir`` in the port (``metrics/tensorboard.py``): the
writer's bytes are the JAX package's writer's for the same scalars with
the clock, the host name and the pid fixed; ``read_scalars`` reads them
back and refuses a corrupt record; and ``Trainer.fit`` writes the JAX
trainer's tags at its steps (``step/*`` at every fetch, ``train/*`` an
epoch, ``eval/*``) from the same weights and batches.
"""

import os
import socket
import time

import jax
import numpy as np
import pytest
from torch_ranks import free_port, unaugmented

import tpu_dist.data.native as jax_native
import tpu_dist_torch.data.native as port_native
from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.metrics import tensorboard as jax_tb
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch import bridge
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.metrics import tensorboard
from tpu_dist_torch.nn import resnet
from tpu_dist_torch.train import trainer

SCALARS = [("train/loss", 2.302585, 0), ("train/lr", 0.1, 0), ("step/loss", float("nan"), 7),
           ("eval/top1", 12.5, 1), ("step/grad_norm", 1e30, 2 ** 40), ("neg", -3.25, -1)]


def _write(mod, d) -> bytes:
    with mod.SummaryWriter(str(d)) as w:
        for tag, v, step in SCALARS:
            w.add_scalar(tag, v, step)
        w.add_scalar("wall", 1.0, 3, wall_time=12345.678)
        w.flush()
        path = w.path
    with open(path, "rb") as f:
        return os.path.basename(path), f.read()


def test_the_bytes_are_jax_s(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host-a")
    monkeypatch.setattr(os, "getpid", lambda: 4242)
    ours = _write(tensorboard, tmp_path / "port")
    theirs = _write(jax_tb, tmp_path / "jax")
    assert ours == theirs
    assert ours[0] == "events.out.tfevents.1700000000.host-a.4242"


def test_read_scalars_reads_them_back_and_checks_the_crcs(tmp_path):
    with tensorboard.SummaryWriter(str(tmp_path)) as w:
        for tag, v, step in SCALARS:
            w.add_scalar(tag, v, step)
        path = w.path
    got = tensorboard.read_scalars(path)
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, _, s in SCALARS]
    for (_, _, v), (_, want, _) in zip(got, SCALARS):
        # simple_value is an f32 field: 0.1 and 2.302585 come back rounded
        assert v == pytest.approx(np.float32(want), nan_ok=True, rel=0)
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="fails its CRC"):
        tensorboard.read_scalars(path)


NARROW = dict(block="basic", stage_blocks=(1, 1, 1, 1), widths=(8, 16, 32, 64))
RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=160,
           batch_size=16, epochs=2, steps_per_epoch=2, lr=0.02, log_every=1, eval_every=1,
           seed=0, device_metrics=True)


@pytest.fixture(scope="module")
def events(tmp_path_factory):
    root = tmp_path_factory.mktemp("tb")
    jax_trainer.register_model("narrow_resnet", lambda num_classes: ResNetDef(
        NARROW["block"], NARROW["stage_blocks"], num_classes, widths=NARROW["widths"]))
    trainer.register_model("narrow_resnet", lambda num_classes, device, seed: resnet.ResNet(
        NARROW["block"], NARROW["stage_blocks"], num_classes, widths=NARROW["widths"],
        device=device, seed=seed))
    mp = pytest.MonkeyPatch()
    for native in (jax_native, port_native):
        mp.setattr(native, "_load", lambda: None)
        mp.setattr(native, "gather_augment", native.gather_augment)
        unaugmented(native)
    try:
        jt = jax_trainer.Trainer(
            JaxConfig(**RUN, tensorboard_dir=str(root / "jax")),
            mesh=mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS], jax.devices()[:1]))
        params, bn_state = (jax.tree_util.tree_map(np.asarray, t)
                            for t in jax.device_get((jt.state.params, jt.state.bn_state)))
        jt.fit()
        pt = trainer.Trainer(TrainConfig(**RUN, tensorboard_dir=str(root / "port"),
                                         device="cpu", port=free_port()))
        try:
            bridge.load_jax_resnet(pt.model, params, bn_state)
            pt.fit()
        finally:
            pt.close()
    finally:
        mp.undo()
    out = []
    for pkg in ("jax", "port"):
        (name,) = os.listdir(root / pkg)
        out.append(tensorboard.read_scalars(str(root / pkg / name)))
    return out


def test_fit_writes_the_jax_trainer_s_tags_at_its_steps(events):
    theirs, ours = events
    assert [(t, s) for t, s, _ in ours] == [(t, s) for t, s, _ in theirs]
    tags = {t for t, _, _ in ours}
    assert {"step/loss", "step/grad_norm", "step/update_ratio", "train/loss", "train/acc1",
            "train/lr", "eval/top1", "eval/top5", "eval/loss"} <= tags
    # every log_every-th step of each epoch, at the global step epoch·nb + step
    nb = 10  # 160 examples in batches of 16
    assert [s for t, s, _ in ours if t == "step/loss"] == [0, 1, nb, nb + 1]


def test_the_values_are_the_jax_trainer_s(events):
    """The lr exactly; the losses and accuracies of the same f32 steps from
    the same weights on the same uncropped batches, in another summation
    order (XLA's fused convolutions against PyTorch's): ~1e-5 of the losses
    after 4 steps (1e-4 relative), a near-tie of the hit counts. The
    gradient norms and update ratios to 1e-2: the JAX step's f32 gradients
    of this narrow ResNet on the CPU are up to ~1% off an f64 evaluation
    where the port's agree with it (ROADMAP Queue C,
    ``test_torch_resnet.py::test_f32_gradients_on_cropped_inputs_match_f64``);
    throughput is a clock, not compared."""
    theirs, ours = events
    for (tag, _, v), (_, _, w) in zip(ours, theirs):
        if tag == "train/images_per_sec":
            continue
        if tag == "train/lr":
            assert v == w
        elif tag.endswith(("acc1", "acc5", "top1", "top5")):
            assert abs(v - w) <= 100.0 / 16 + 1e-6, tag
        elif tag in ("step/grad_norm", "step/update_ratio"):
            np.testing.assert_allclose(v, w, rtol=1e-2, err_msg=tag)
        else:
            np.testing.assert_allclose(v, w, rtol=1e-4, err_msg=tag)
