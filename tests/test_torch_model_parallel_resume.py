"""The plain checkpoint under ``--tp``: a ``--tp 2`` run (2 gloo ranks)
writes its epoch-0 checkpoint in JAX's full layout (the shards and their
momentum gathered to rank 0, as the JAX ``save`` gathers its sharded
leaves); ``--tp 1`` (1 rank) and ``--tp 4`` (4 ranks) resume from it, each
rank taking its slices, and train epoch 1 as the uninterrupted ``--tp 2``
run does; JAX's ``restore`` reads the file into a ``vit_tiny``
``TrainState``, and the serving engine's ``load_serving_state`` loads it
into a one-device ViT."""

import os
import shutil

import jax
import numpy as np
import pytest
from model_parallel_jax import FIT_LOSS_TOL, FIT_RUN
from torch_ranks import mp_fit_rank, run_ranks

from tpu_dist.ckpt import checkpoint as jax_ckpt
from tpu_dist.nn.vit import vit_tiny as jax_vit_tiny
from tpu_dist.train.optim import SGD as JaxSGD
from tpu_dist.train.state import TrainState as JaxState
from tpu_dist_torch import bridge
from tpu_dist_torch.nn import vit
from tpu_dist_torch.serve.engine import load_serving_state

RUN = dict(FIT_RUN, model="vit_tiny", device="cpu")


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_ckpt"))
    # the uninterrupted 2-epoch run, and the 1-epoch run that saves
    whole, saved = run_ranks(mp_fit_rank, 2, [dict(RUN, tp=2),
                                              dict(RUN, tp=2, epochs=1, ckpt_dir="a")],
                             None, root, timeout=120)[0]
    for d in ("b", "c"):
        shutil.copytree(os.path.join(root, "a"), os.path.join(root, d))
    one = run_ranks(mp_fit_rank, 1, [dict(RUN, tp=1, ckpt_dir="b", resume=True)], None, root,
                    timeout=120)[0][0]
    four = run_ranks(mp_fit_rank, 4, [dict(RUN, tp=4, ckpt_dir="c", resume=True)], None, root,
                     timeout=120)[0][0]
    return root, whole, saved, {1: one, 4: four}


@pytest.mark.parametrize("tp", [1, 4])
def test_a_tp2_checkpoint_resumes_at_another_model_group_size(resumed, tp):
    """The resume starts at epoch 1 and trains it as the uninterrupted run
    does: the same weights and momentum, sliced for ``tp`` ranks (f32: the
    shards sum their partial products in another grouping)."""
    _, whole, _, runs = resumed
    r = runs[tp]
    assert r["start_epoch"] == 1 and len(r["epochs"]) == 1
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(r["epochs"][0][key], whole["epochs"][1][key], **FIT_LOSS_TOL,
                                   err_msg=key)


def test_jax_restore_reads_the_tp2_checkpoint(resumed):
    """The file holds JAX's full ViT layout: ``tpu_dist.ckpt.restore``
    shapes it onto a ``vit_tiny`` SGD ``TrainState``, and its parameters
    are the saving run's final weights, gathered."""
    root, _, saved, _ = resumed
    md = jax_vit_tiny()
    params, _ = jax.eval_shape(md.init, jax.random.PRNGKey(0))
    template = JaxState.create(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                      params), {}, JaxSGD())
    st = jax_ckpt.restore(os.path.join(root, "a", "ckpt_0.npz"), template)
    assert int(st.step) == 2
    for a, b in zip(jax.tree_util.tree_leaves(st.params),
                    jax.tree_util.tree_leaves(saved["final"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    # momentum: SGD's buffers mirror the parameters, full width
    for a, b in zip(jax.tree_util.tree_leaves(st.opt_state), jax.tree_util.tree_leaves(params)):
        assert np.shape(a) == b.shape


def test_the_tp2_checkpoint_loads_into_the_serving_engine(resumed):
    root, _, saved, _ = resumed
    model = vit.vit_tiny(device="cpu")
    w = load_serving_state(os.path.join(root, "a"), model)
    bridge.load_jax_params(model, w["params"], w["bn_state"])
    for a, b in zip(jax.tree_util.tree_leaves(bridge.vit_params_to_jax(model)),
                    jax.tree_util.tree_leaves(saved["final"])):
        np.testing.assert_array_equal(a, b)
