"""The plain checkpoint under ``--pp 2 --pp_interleave 2`` (2 gloo ranks):
the run writes its epoch-0 checkpoint in JAX's full stacked layout, in the
interleaved storage order (each stage's rows and their momentum gathered
to rank 0); the port resumes it under the same flags and trains epoch 1 as
the uninterrupted run does; JAX's ``restore`` reads the file into the
interleaved ``ViTPipelineDef``'s ``TrainState``; a resume under another
layout, and an interleaved resume of a checkpoint without the layout tag,
are refused with the JAX trainer's messages."""

import json
import os
import shutil
import types

import jax
import numpy as np
import pytest
from model_parallel_jax import FIT_LOSS_TOL, FIT_RUN
from torch_ranks import free_port, mp_fit_rank, run_ranks, trainer_errors_rank

from tpu_dist.ckpt import checkpoint as jax_ckpt
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.nn.vit_pp import ViTPipelineDef
from tpu_dist.train import trainer as jax_trainer
from tpu_dist.train.optim import SGD as JaxSGD
from tpu_dist.train.state import TrainState as JaxState
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.train import trainer

RUN = dict(FIT_RUN, model="vit_pp_tiny", pp=2, pp_interleave=2, device="cpu")


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pp_ckpt"))
    whole, saved, again = run_ranks(
        mp_fit_rank, 2, [RUN, dict(RUN, epochs=1, ckpt_dir="a"),
                         dict(RUN, ckpt_dir="a", resume=True)], None, root, timeout=120)[0]
    return root, whole, saved, again


def test_the_port_resumes_its_interleaved_checkpoint(resumed):
    """The resume starts at epoch 1 and trains it as the uninterrupted run
    does (the same weights, momentum and batches in the same layout)."""
    _, whole, _, again = resumed
    assert again["start_epoch"] == 1 and len(again["epochs"]) == 1
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(again["epochs"][0][key], whole["epochs"][1][key],
                                   **FIT_LOSS_TOL, err_msg=key)


def test_jax_restore_reads_the_interleaved_checkpoint(resumed):
    """The file holds JAX's stacked layout in the storage order of pp 2 x
    v 2: ``tpu_dist.ckpt.restore`` shapes it onto the interleaved
    ``vit_pp_tiny`` SGD ``TrainState``, and its parameters are the saving
    run's final weights, gathered, row for row."""
    root, _, saved, _ = resumed
    md = ViTPipelineDef(interleave=2, pp_stages=2)
    params, _ = jax.eval_shape(md.init, jax.random.PRNGKey(0))
    template = JaxState.create(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                      params), {}, JaxSGD())
    st = jax_ckpt.restore(os.path.join(root, "a", "ckpt_0.npz"), template)
    assert int(st.step) == 2
    for a, b in zip(jax.tree_util.tree_leaves(st.params),
                    jax.tree_util.tree_leaves(saved["final"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert st.params["blocks"]["qkv"]["w"].shape == (4, 64, 192)


def _messages(meta, path, **cfg):
    """``"TypeName: message"`` of both trainers' layout check on ``meta``."""
    out = []
    for check, config in ((jax_trainer.Trainer._check_ckpt_meta, JaxConfig),
                          (trainer.Trainer._check_ckpt_meta, TrainConfig)):
        try:
            check(types.SimpleNamespace(cfg=config(**cfg)), meta, path)
        except ValueError as e:  # the refusal under test
            out.append(f"{type(e).__name__}: {e}")
    return out


def test_another_layout_is_refused_with_jaxs_message(resumed):
    """The checkpoint's ``{pp: 2, pp_interleave: 2}`` stamp against a resume
    without interleaving (at pp 2, and at pp 1 on one rank, where the
    port's ``Trainer`` raises it from the restore), and a checkpoint
    without the stamp against an interleaved resume."""
    root = resumed[0]
    path = os.path.join(root, "a", "ckpt_0.npz")
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
    assert (meta["pp"], meta["pp_interleave"]) == (2, 2)
    for cfg in (dict(pp=2, pp_interleave=1), dict(pp=1, pp_interleave=1),
                dict(pp=4, pp_interleave=2)):
        jax_msg, port_msg = _messages(meta, path, **cfg)
        assert "layout-specific" in jax_msg and port_msg == jax_msg
    untagged = {k: v for k, v in meta.items() if k not in ("pp", "pp_interleave")}
    jax_msg, port_msg = _messages(untagged, path, pp=2, pp_interleave=2)
    assert "no pipeline-layout tag" in jax_msg and port_msg == jax_msg
    shutil.copytree(os.path.join(root, "a"), os.path.join(root, "b"))
    for name in os.listdir(os.path.join(root, "b")):
        if name != "ckpt_0.npz":
            os.remove(os.path.join(root, "b", name))
    err = trainer_errors_rank(0, 1, [dict(RUN, pp=1, pp_interleave=1, resume=True,
                                          ckpt_dir=os.path.join(root, "b"), port=free_port())])
    want = _messages(meta, os.path.join(root, "b", "ckpt_0.npz"), pp=1, pp_interleave=1)[0]
    assert err == [want.replace("ValueError", "ConfigMismatchError")]
