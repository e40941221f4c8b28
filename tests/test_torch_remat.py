"""The train step's ``remat`` in the port (``tpu_dist_torch/train/step.py``:
the forward and loss under ``torch.utils.checkpoint``), as
``tests/test_remat.py`` holds the JAX step's ``jax.checkpoint``.

* Against the port's plain step, one CPU process: the loss, parameters,
  momentum and BN running statistics after two steps, bit for bit (the
  recomputed forward is the same f32 or bf16 operations on the same
  inputs, and it leaves the running statistics alone); with gradient
  accumulation (K = 2) and at bf16 too.
* Over 2 gloo ranks with SyncBN: the same state bit for bit, and the
  recomputed forward's SyncBN all-reduces: ``comm.all_reduce.bn`` counts
  twice the plain step's, ``bn_grad`` and ``grad`` the same.
* Against the JAX step built with ``remat=True``, from the same weights on
  the same batches.
"""

import jax
import numpy as np
import pytest
import torch
from torch_ranks import remat_rank, run_ranks

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.train import optim as jax_optim
from tpu_dist.train import state as jax_state
from tpu_dist.train import step as jax_step
from tpu_dist_torch import bridge
from tpu_dist_torch.nn import resnet
from tpu_dist_torch.train import optim, state, step

MODEL = dict(block="basic", stage_blocks=(1, 1, 1, 1), num_classes=10, widths=(8, 16, 32, 64))


def _batches(n=16):
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, n).astype(np.int32), lr) for lr in (0.1, 0.05)]


def _port_run(remat, *, K=1, dtype=torch.float32, opt_cls=optim.SGD):
    model = resnet.ResNet(**MODEL, device="cpu", seed=0)
    opt = opt_cls()
    st = state.TrainState.create(model, opt)
    train_step = step.make_train_step(opt, grad_accum_steps=K, compute_dtype=dtype, remat=remat)
    losses = []
    for images, labels, lr in _batches():
        st, m = train_step(st, images, labels, lr)
        losses.append(m["loss"].item())
    opt_state = st.opt_state if isinstance(st.opt_state, list) else st.opt_state["mu"]
    return losses, model.state_dict(), opt_state


@pytest.mark.parametrize("case", ["f32-K1-sgd", "f32-K2-sgd", "bf16-K2-sgd", "f32-K1-adamw"])
def test_remat_is_the_plain_step_bit_for_bit(case):
    dt, k, opt_name = case.split("-")
    kw = dict(K=int(k[1:]), dtype=torch.bfloat16 if dt == "bf16" else torch.float32,
              opt_cls=optim.AdamW if opt_name == "adamw" else optim.SGD)
    plain, remat = _port_run(False, **kw), _port_run(True, **kw)
    assert plain[0] == remat[0] and all(np.isfinite(plain[0]))
    for key, t in plain[1].items():
        assert torch.equal(t, remat[1][key]), key  # parameters and running statistics
    for a, b in zip(plain[2], remat[2]):
        assert torch.equal(a, b)
    # the running statistics moved: one EMA a chunk, not two
    assert not torch.equal(plain[1]["stem_bn.running_var"], torch.ones_like(
        plain[1]["stem_bn.running_var"]))


def test_remat_over_two_gloo_ranks_recomputes_the_syncbn_all_reduce():
    ranks = run_ranks(remat_rank, 2, MODEL, _batches(32), timeout=180)
    for out in ranks:
        plain, remat = out[False], out[True]
        for key in plain["state"]:
            np.testing.assert_array_equal(plain["state"][key], remat["state"][key], err_msg=key)
        for a, b in zip(plain["momentum"], remat["momentum"]):
            np.testing.assert_array_equal(a, b)
        p, r = plain["counts"], remat["counts"]
        # 2 steps x 12 BN layers; the recomputation runs each forward again
        assert p["comm.all_reduce.bn"] == 24 and r["comm.all_reduce.bn"] == 48
        for kind in ("bn_grad", "grad", "metrics"):
            assert r[f"comm.all_reduce.{kind}"] == p[f"comm.all_reduce.{kind}"] > 0, kind
    for key in ranks[0][True]["state"]:
        np.testing.assert_array_equal(ranks[0][True]["state"][key], ranks[1][True]["state"][key])


# f32, the same two steps of the same model in two frameworks (another
# summation order in the convolutions): tests/test_torch_dp_step.py's
# limits, the loss to 1e-5 and every weight, momentum and running
# statistic to 2e-5 relative plus 5e-6.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=2e-5, atol=5e-6)


def test_remat_matches_the_jax_remat_step():
    md = ResNetDef(MODEL["block"], MODEL["stage_blocks"], MODEL["num_classes"],
                   widths=MODEL["widths"])
    params, bn_state = jax.tree_util.tree_map(np.asarray, jax.jit(md.init)(jax.random.PRNGKey(0)))
    mesh = mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS], jax.devices()[:1])
    opt = jax_optim.SGD(momentum=0.9, weight_decay=1e-4)
    st = jax.device_put(jax_state.TrainState.create(params, bn_state, opt),
                        mesh_lib.replicated(mesh))
    jstep = jax_step.make_train_step(md.apply, opt, mesh, donate=False, remat=True)
    model = bridge.load_jax_resnet(resnet.ResNet(**MODEL, device="cpu"), params, bn_state)
    popt = optim.SGD(momentum=0.9, weight_decay=1e-4)
    pst = state.TrainState.create(model, popt)
    pstep = step.make_train_step(popt, remat=True)
    for images, labels, lr in _batches():
        st, jm = jstep(st, images, labels, lr)
        pst, pm = pstep(pst, images, labels, lr)
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), **LOSS_TOL)
    st = jax.device_get(st)
    got_p, got_s = bridge.resnet_params_to_jax(model)
    got_m = bridge.resnet_sgd_state_to_jax(model, pst.opt_state)
    for ours, theirs in ((got_p, st.params), (got_s, st.bn_state), (got_m, st.opt_state)):
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_allclose(a, np.asarray(b), **STATE_TOL)
