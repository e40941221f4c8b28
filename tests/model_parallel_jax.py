"""The JAX side and the shared inputs of the port's tensor- and
expert-parallel tests (``test_torch_tensor_parallel.py``,
``test_torch_moe.py``, ``test_torch_expert_parallel.py``,
``test_torch_model_parallel_trainer.py``): the models of the JAX package's
own TP/EP tests, their weights (numpy), the batches, the JAX steps on the 8
CPU devices and the JAX ``Trainer`` on a given mesh. The gloo ranks import
only ``torch_ranks``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from torch_ranks import unaugmented

import tpu_dist.data.native as jax_native
from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.nn.vit import ViTDef
from tpu_dist.nn.vit_moe import ViTMoEDef
from tpu_dist.train import trainer as jax_trainer
from tpu_dist.train.optim import SGD as JaxSGD
from tpu_dist.train.state import TrainState as JaxState
from tpu_dist.train.step import make_train_step as jax_make_train_step
from tpu_dist_torch import bridge
from tpu_dist_torch.nn import vit

# tests/test_tensor_parallel_training.py's model: 4 heads (1 a rank at tp 4)
TP_KW = dict(image_size=32, patch_size=4, dim=32, depth=2, heads=4, num_classes=5)
# tests/test_expert_parallel_training.py's model at the trainer's capacity
# factor (2.0): some tokens overflow their expert's capacity
MOE_KW = dict(image_size=16, patch_size=4, dim=32, depth=1, heads=4, n_experts=8,
              capacity_factor=2.0, num_classes=5)
LR = 0.05

# The JAX tests' own bounds for a sharded step against one device
# (tests/test_tensor_parallel_training.py): the same f32 gradients summed
# in another order (per-shard partial sums, the all-reduces), carried by 3
# SGD steps into the weights (|w| <~ 2) at ~1e-5 relative.
SINGLE_TOL = dict(rtol=5e-4, atol=5e-5)
LOSS_TOL = dict(rtol=1e-4)
# Against the JAX step of the same sharding: the same sums in another
# order (XLA's fused ops vs PyTorch's), a few f32 ulps a step.
SAME_TOL = dict(rtol=1e-5, atol=2e-6)


def tp_params():
    """The TP model's weights from numpy seed 0, as the JAX tree."""
    return bridge.numpy_vit_params(vit.ViT(**TP_KW, device="cpu"), seed=0)


def moe_params(top_k=1):
    """The MoE model's weights from ``ViTMoEDef.init(PRNGKey(0))``, numpy."""
    md = ViTMoEDef(**MOE_KW, top_k=top_k)
    params, _ = jax.jit(md.init)(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def batches(image_size, num_classes, n=8, steps=3, seed=0):
    """``steps`` global batches ``(images [n, s, s, 3], labels, lr)``."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, image_size, image_size, 3)).astype(np.float32),
             rng.integers(0, num_classes, n).astype(np.int32), LR) for _ in range(steps)]


def jax_run(model, params, mesh, batch_list, specs=None, batch_axes=mesh_lib.DATA_AXIS, **kw):
    """The JAX step of ``model`` from ``params`` on ``mesh`` (the leaves
    placed by ``specs``, else replicated): (losses, final params numpy)."""
    opt = JaxSGD()
    st = JaxState.create(jax.tree_util.tree_map(jnp.asarray, params), {}, opt)
    if specs is None:
        st = jax.device_put(st, mesh_lib.replicated(mesh))
    else:
        def place(tree):
            return jax.tree_util.tree_map(
                lambda leaf, spec: jax.device_put(leaf, NamedSharding(mesh, spec)), tree, specs)

        st = JaxState(params=place(st.params),
                      bn_state=jax.device_put(st.bn_state, mesh_lib.replicated(mesh)),
                      opt_state=place(st.opt_state),
                      step=jax.device_put(st.step, mesh_lib.replicated(mesh)))
    train_step = jax_make_train_step(model.apply, opt, mesh, sync_bn=False, donate=False,
                                     param_specs=specs, **kw)
    losses = []
    for x, y, lr in batch_list:
        st, m = train_step(st, mesh_lib.shard_batch(mesh, x, batch_axes),
                           mesh_lib.shard_batch(mesh, y, batch_axes), lr)
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, jax.device_get(st.params))


def mesh_of(shape, names):
    return mesh_lib.device_mesh(list(shape), list(names), jax.devices()[:int(np.prod(shape))])


def single_device_run(model, params, batch_list, **kw):
    return jax_run(model, params, mesh_of([1], ["data"]), batch_list, **kw)


def tp_model():
    return ViTDef(**TP_KW)


def moe_model(top_k=1):
    return ViTMoEDef(**MOE_KW, top_k=top_k)


def assert_params(got, want, tol, what):
    got_l, want_l = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, **tol, err_msg=what)


# -- the trainer ---------------------------------------------------------------

FIT_RUN = dict(num_classes=10, dataset="synthetic", synthetic_n=160, batch_size=16, epochs=2,
               steps_per_epoch=2, lr=0.05, log_every=1, eval_every=1, seed=0)
# f32, the same 4 steps at lr 0.05 from the same weights on the same
# unaugmented batches: the two sharded steps sum the same gradients in
# another order (XLA's fused ops vs PyTorch's, the shards' partial sums),
# a few ulps a step, which 4 steps carry into the loss (~2.3) and the eval
# loss at ~1e-6 relative.
FIT_LOSS_TOL = dict(rtol=1e-4)


def jax_fit(run, shape, names):
    """The JAX ``Trainer`` of ``run`` on the ``shape``/``names`` mesh, its
    augmentation held to the numpy path without crops
    (``torch_ranks.unaugmented``): its initial weights (numpy) and its
    epoch dicts."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_load", lambda: None)
    mp.setattr(jax_native, "gather_augment", jax_native.gather_augment)
    unaugmented(jax_native)
    try:
        jt = jax_trainer.Trainer(JaxConfig(**run), mesh=mesh_of(shape, names))
        params = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.state.params))
        epochs, inner = [], jt.train_epoch

        def train_epoch(epoch, *a, **k):
            epochs.append(inner(epoch, *a, **k))
            return epochs[-1]

        jt.train_epoch = train_epoch
        jt.fit()
    finally:
        mp.undo()
    return params, epochs


def assert_fit_matches(jax_epochs, fits, tol=FIT_LOSS_TOL):
    """Every rank's fit (each reads the same all-reduced metrics) against
    the JAX trainer's epochs."""
    assert len(jax_epochs) == 2
    for r in fits:
        for ours, theirs in zip(r["epochs"], jax_epochs):
            assert ours["steps"] == theirs["steps"] == 2
            for key in ("loss", "val_loss"):
                np.testing.assert_allclose(ours[key], theirs[key], **tol, err_msg=key)
            # logits this close agree on every hit but near-ties: none here
            for key in ("acc1", "acc5", "val_top1", "val_top5"):
                assert ours[key] == pytest.approx(theirs[key], abs=1e-9), key


def check_tp_fit(jax_epochs, ranks, sp=1):
    """Every rank of a ``--tp`` run's model groups trains the data row's
    batch (16, the whole global batch at one data row) and evaluates its
    data x seq shard's (16 / sp); the losses, the eval loss and the hits
    match the JAX trainer's."""
    for r in ranks:
        assert r["n_data"] == 1 and r["batches"] == (16, 16 // sp)
    assert_fit_matches(jax_epochs, ranks)


def check_tp_ledger(ranks, n_params=107_978, sharded=12):
    """vit_tiny under ``--tp 2``: each block's qkv/mlp1 weights and biases
    and proj/mlp2 weights are sharded (6 a block), and a device holds their
    halves: its parameter bytes are its own shards' and the replicated
    leaves'. The ranks' gathered final weights agree."""
    for r in ranks:
        sec = r["ledger"]
        assert sec["sharded_leaves"] == sharded
        assert sec["bytes_total"] == n_params * 4
        assert sec["bytes_per_device"] == r["local_numel"] * 4 < sec["bytes_total"]
        assert all(e["sharded"] == (e["bytes_per_device"] < e["bytes_total"]) for e in sec["top"])
    for r in ranks[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(r["final"]),
                        jax.tree_util.tree_leaves(ranks[0]["final"])):
            np.testing.assert_array_equal(a, b)
