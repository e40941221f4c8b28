"""The JAX side and the shared inputs of the port's sequence-parallel
tests. For the attention (``test_torch_seq_parallel.py``,
``test_torch_ring_flash.py``): one set of numpy inputs, the JAX functions
inside ``shard_map`` over a 4-device ``seq`` mesh (jitted, forward and VJP
in one program), and the layout helpers between [B, S, H, D] arrays and
the ranks' [BH, S/n, D] blocks. For the step
(``test_torch_seq_parallel_step.py``, ``test_torch_seq_parallel_zero1.py``):
the model, its numpy weights, the batches and the JAX step's run. For the
trainer (``test_torch_seq_parallel_trainer.py``,
``test_torch_seq_parallel_fit.py``): the JAX ``Trainer`` on a [2, 2] mesh.
The gloo ranks import only ``torch_ranks``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_ranks import unaugmented

import tpu_dist.data.native as jax_native

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.comm.compat import shard_map
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.nn import attention as jax_attention
from tpu_dist.nn.vit import ViTDef
from tpu_dist.ops import flash_attention as jax_flash
from tpu_dist.train.optim import SGD as JaxSGD
from tpu_dist.train.state import TrainState as JaxState
from tpu_dist.train import trainer as jax_trainer
from tpu_dist.train.step import make_train_step as jax_make_train_step
from tpu_dist_torch import bridge
from tpu_dist_torch.nn import vit

N = 4
SHAPE = (2, 64, 4, 16)  # [B, S, H, D]: 16 tokens a rank, D = 16 (a kernel head dim)

# f32, the same online softmax on both sides in another summation order
# (XLA's dots vs PyTorch's matmuls, the merge's exp over other groupings):
# outputs (|o| <~ 2) and gradients (|g| <~ 10) agree to a few f32 ulps of
# their size.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 causal ring flash: both sides compute in f32 from the same bf16
# inputs but round P (and dS) to bf16 at other places (the port's plain
# kernels round P once against the final row max of the rotation's block,
# the Pallas kernel against each 16-key tile's running max), and the output
# and gradients come back as bf16: one or two bf16 steps (2^-8 relative)
# of values up to ~10, the bound JAX's own bf16 ring test uses.
BF16_TOL = dict(rtol=4e-2, atol=4e-2)


def inputs():
    """q, k, v and the cotangent ct, [B, S, H, D] f32 from numpy seed 18."""
    rng = np.random.default_rng(18)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def case_id(case) -> str:
    name, causal, dtype = case
    return f"{name}-{'causal' if causal else 'full'}-{dtype or 'f32'}"


def _jax_fn(name, causal):
    if name == "ring":
        return lambda q, k, v: jax_attention.ring_attention(q, k, v, "seq", causal=causal)
    if name == "ulysses":
        return lambda q, k, v: jax_attention.ulysses_attention(q, k, v, "seq", causal=causal)
    return lambda q, k, v: jax_flash.ring_flash_attention(q, k, v, "seq", causal=causal,
                                                          block_q=16, block_k=16)


def jax_case(name, causal, dtype, q, k, v, ct):
    """The JAX function over a 4-device seq mesh: (out, (dq, dk, dv)), f32."""
    mesh = mesh_lib.device_mesh([N], ["seq"], jax.devices()[:N])
    fn = shard_map(_jax_fn(name, causal), mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                   out_specs=P(None, "seq"), check_vma=False)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    @jax.jit
    def run(q, k, v, ct):
        out, vjp = jax.vjp(lambda *a: fn(*a).astype(jnp.float32), q, k, v)
        return out, [g.astype(jnp.float32) for g in vjp(ct)]

    out, grads = run(*(jnp.asarray(a).astype(dt) for a in (q, k, v)), jnp.asarray(ct))
    return np.asarray(out), [np.asarray(g) for g in grads]


def gathered(ranks, i):
    """Case ``i``'s output and gradients of every rank, joined along S."""
    out = np.concatenate([r[i]["out"] for r in ranks], axis=1)
    grads = [np.concatenate([r[i]["grads"][j] for r in ranks], axis=1) for j in range(3)]
    return out, grads


def assert_matches_jax(ranks, cases, i):
    name, causal, dtype = cases[i]
    want_out, want_grads = jax_case(name, causal, dtype, *inputs())
    out, grads = gathered(ranks, i)
    tol = BF16_TOL if dtype else F32_TOL
    np.testing.assert_allclose(out, want_out, **tol, err_msg="out")
    for g, w, what in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(g, w, **tol, err_msg=f"d{what}")


def blocks(a, dtype=torch.float32):
    """The ranks' [BH, S/n, D] blocks of a global [B, S, H, D] array."""
    b, s, h, d = a.shape
    t = torch.from_numpy(a).permute(0, 2, 1, 3).reshape(b * h, s, d).to(dtype)
    return [c.contiguous() for c in t.chunk(N, dim=1)]


def unblock(t, like_shape):
    """A rank's [BH, S/n, D] block as its [B, S/n, H, D] f32 numpy shard."""
    b, _, h, d = like_shape
    return t.reshape(b, h, -1, d).permute(0, 2, 1, 3).float().numpy()


# -- the step ------------------------------------------------------------------

# tests/test_seq_parallel_training.py's model: 64 tokens, 2 heads (both
# divide over a seq group of 2)
MODEL_KW = dict(image_size=32, patch_size=4, dim=32, depth=2, heads=2, num_classes=5)
LR = 0.05

# The JAX test's own bounds for DP x SP against one device
# (tests/test_seq_parallel_training.py): the sharded step sums the same
# f32 gradients in another order (per-shard partial sums, a ring's merged
# softmax partials, two reduces), and 3 SGD steps carry that into the
# weights (|w| <~ 2) at ~1e-5 relative.
SINGLE_TOL = dict(rtol=3e-4, atol=3e-5)
LOSS_TOL = dict(rtol=1e-4)


def step_batches():
    """3 global batches ``(images [8, 32, 32, 3], labels, lr)``, numpy seed 0."""
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 5, 8).astype(np.int32), LR) for _ in range(3)]


def step_params():
    """The model's weights from numpy seed 0, as the JAX tree."""
    return bridge.numpy_vit_params(vit.ViT(**MODEL_KW, device="cpu"), seed=0)


def jax_run(params, mesh, batches, **kw):
    """The JAX step from ``params`` on ``mesh``: (losses, final params)."""
    opt = JaxSGD()
    st = jax.device_put(JaxState.create(jax.tree_util.tree_map(jnp.asarray, params), {}, opt),
                        mesh_lib.replicated(mesh))
    train_step = jax_make_train_step(ViTDef(**MODEL_KW).apply, opt, mesh, sync_bn=False,
                                     donate=False, **kw)
    losses = []
    for x, y, lr in batches:
        st, m = train_step(st, mesh_lib.shard_batch(mesh, x), mesh_lib.shard_batch(mesh, y), lr)
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, jax.device_get(st.params))


def single_device_run():
    """The JAX step on one device over :func:`step_batches`."""
    mesh1 = mesh_lib.device_mesh([1], ["data"], jax.devices()[:1])
    return jax_run(step_params(), mesh1, step_batches())


def assert_params(got, want, tol, what):
    got_l, want_l = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, **tol, err_msg=what)


def assert_matches_single_device(ranks, i, single, what):
    """Case ``i`` of every rank (each holds the same replicated result)
    against the single-device run."""
    want_losses, want_params = single
    for r in ranks:
        np.testing.assert_allclose(r[i]["losses"], want_losses, **LOSS_TOL)
        assert_params(r[i]["params"], want_params, SINGLE_TOL, what)


# -- the trainer ---------------------------------------------------------------

FIT_RUN = dict(model="vit_tiny", num_classes=10, dataset="synthetic", synthetic_n=160,
               batch_size=16, epochs=2, steps_per_epoch=2, lr=0.05, log_every=1,
               eval_every=1, seed=0, sp=2)
# f32, the same 4 steps at lr 0.05 from the same weights on the same
# unaugmented batches: the two sharded steps sum the same gradients in
# another order (XLA's fused ops vs PyTorch's, the data row's examples
# strided here and contiguous there), a few ulps a step, which 4 steps
# carry into the loss (~2.3) and the eval loss at ~1e-6 relative.
FIT_LOSS_TOL = dict(rtol=1e-4)


def jax_fit(mode):
    """The JAX ``Trainer`` of :data:`FIT_RUN` with ``sp_mode=mode`` on a
    [2, 2] data x seq mesh, its augmentation held to the numpy path without
    crops (``torch_ranks.unaugmented``): its initial weights (numpy) and
    its epoch dicts."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_load", lambda: None)
    mp.setattr(jax_native, "gather_augment", jax_native.gather_augment)
    unaugmented(jax_native)
    try:
        mesh = mesh_lib.device_mesh([2, 2], [mesh_lib.DATA_AXIS, mesh_lib.SEQ_AXIS],
                                    jax.devices()[:4])
        jt = jax_trainer.Trainer(JaxConfig(**FIT_RUN, sp_mode=mode), mesh=mesh)
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


def assert_fit_matches(jax_epochs, fits):
    """Every rank's fit (each reads the same all-reduced metrics) against
    the JAX trainer's epochs."""
    assert len(jax_epochs) == 2
    for r in fits:
        assert r["n_data"] == 2 and r["batches"] == (8, 4)
        for ours, theirs in zip(r["epochs"], jax_epochs):
            assert ours["steps"] == theirs["steps"] == 2
            for key in ("loss", "val_loss"):
                np.testing.assert_allclose(ours[key], theirs[key], **FIT_LOSS_TOL, err_msg=key)
            # logits this close agree on every hit but near-ties: none here
            for key in ("acc1", "acc5", "val_top1", "val_top5"):
                assert ours[key] == pytest.approx(theirs[key], abs=1e-9), key
