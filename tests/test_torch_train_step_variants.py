"""Options of the port's train step held against the JAX ``make_train_step``
on a one-device mesh: gradient accumulation, label smoothing with global
norm clipping, and bf16 compute. Same set-up as ``test_torch_train_step.py``
(``vit_tiny``, bridged numpy-seed weights, flash attention, fused SGD; the
JAX side in Pallas interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_train_step import LOSS_TOL, LRS, assert_state_close, batch, jax_setup
import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist_torch import bridge
from tpu_dist_torch.train import optim, state, step


def _run(n_steps, jax_kw, port_kw):
    jstep, jstate, model, _ = jax_setup(**jax_kw)
    tstate = state.TrainState.create(model, optim.SGD(fused=True))
    tstep = step.make_train_step(optim.SGD(fused=True), **port_kw)
    losses = []
    for i, lr in enumerate(LRS[:n_steps]):
        x, y = batch(i)
        jstate, jm = jstep(jstate, x, y, lr)
        tstate, tm = tstep(tstate, x, y, lr)
        losses.append((tm["loss"].item(), float(jm["loss"])))
    return tstate, jstate, losses


def test_grad_accumulation_over_two_chunks_matches_jax():
    """K = 2: the chunk grads are summed and halved, the loss is the mean
    of the two chunk losses, the metrics read both chunks' logits."""
    tstate, jstate, losses = _run(3, {"grad_accum_steps": 2}, {"grad_accum_steps": 2})
    for ours, theirs in losses:
        np.testing.assert_allclose(ours, theirs, **LOSS_TOL)
    assert_state_close(tstate, jstate)


def test_label_smoothing_and_grad_clip_match_jax():
    """Smoothing 0.1 changes the loss; a clip norm of 0.5 sits below the
    gradient norm of every step here, so the clip scales each update."""
    kw = {"label_smoothing": 0.1, "grad_clip_norm": 0.5}
    tstate, jstate, losses = _run(3, kw, kw)
    for ours, theirs in losses:
        np.testing.assert_allclose(ours, theirs, **LOSS_TOL)
    assert_state_close(tstate, jstate)


def test_grad_clip_engages_after_the_loss():
    """From zero momentum one step leaves b = g + wd * p_before, with
    p_before = p + lr * b: the clipped gradient g has the clip's norm, and
    the step's loss is the unclipped step's (clipping acts after it)."""
    runs = {}
    for clip in (0.0, 0.5):
        _, _, model, _ = jax_setup()  # the bridged weights only
        tstate = state.TrainState.create(model, optim.SGD())
        tstep = step.make_train_step(optim.SGD(), label_smoothing=0.1, grad_clip_norm=clip)
        runs[clip] = tstep(tstate, *batch(0), LRS[0])
    (clipped, m_clip), (_, m_plain) = runs[0.5], runs[0.0]
    assert m_clip["loss"].item() == m_plain["loss"].item()
    sq = 0.0
    for p, b in zip(clipped.params.parameters(), clipped.opt_state):
        g = b - 1e-4 * (p.detach() + LRS[0] * b)
        sq += float(torch.sum(g.double() ** 2))
    # p_before is rebuilt in f32 (one rounding per entry): ~1e-7 relative
    assert abs(sq ** 0.5 - 0.5) < 1e-5


def test_one_bf16_step_matches_jax_loosely():
    """bf16 compute over f32 master weights. Both sides round to bf16 at the
    same casts (images, weights, LayerNorm scale and bias) but XLA keeps f32
    inside its fused elementwise chains where PyTorch rounds after each op,
    so activations drift by a few bf16 steps (2^-8 relative each): the loss
    agrees to ~5e-4 relative. Each gradient leaf (the momentum after one
    step) is compared by its relative L2 error: weight matrices to ~0.7%;
    bias vectors are sums over 512 rows of bf16 terms that largely cancel,
    so the two frameworks' accumulation precision shows there, up to ~4.5%."""
    tstate, jstate, losses = _run(1, {"compute_dtype": jnp.bfloat16},
                                  {"compute_dtype": torch.bfloat16})
    np.testing.assert_allclose(*losses[0], rtol=2e-3)
    ours = jax.tree_util.tree_leaves(bridge.sgd_state_to_jax(tstate.params, tstate.opt_state))
    theirs = jax.tree_util.tree_leaves(jstate.opt_state)
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        rel = 1.5e-2 if b.ndim > 1 else 6e-2
        assert np.linalg.norm(a - b) <= rel * np.linalg.norm(b)
    # the master weights stay f32
    assert all(p.dtype == torch.float32 for p in tstate.params.parameters())
