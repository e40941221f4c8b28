"""The port's AdamW, LARS and LAMB (``tpu_dist_torch/train/optim.py``) held
against the live JAX optimizers of ``tpu_dist/train/optim.py``.

Five steps on the leaves of a narrow ResNet and of ``vit_tiny``, with the
same numpy-seeded gradients on both sides: the JAX optimizer updates the
JAX-layout pytree, the port's updates the module's tensors in place, and
the bridge carries the result back to the JAX layout for the comparison.
One matrix starts at zero (the trust ratio's ``‖p‖ = 0`` fallback) and
another gets a zero gradient at every step (its ``‖g‖ = 0`` fallback).
The rank ≤ 1 rule of AdamW's ``auto`` mask, LARS and LAMB reads the port's
tensor; a test holds its rank to the JAX leaf's for every model of the
zoo.
"""

import jax
import numpy as np
import pytest
import torch
import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.train import optim as jax_optim
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch import bridge
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.nn import resnet, vit
from tpu_dist_torch.train import optim
from tpu_dist_torch.train import trainer

STEPS = 5
# the optimizers at weight decays large enough to move the update
OPTIMIZERS = {
    "adamw_auto": (lambda m: m.AdamW(weight_decay=0.05, decay_mask="auto"), 1e-3),
    "adamw_all": (lambda m: m.AdamW(weight_decay=0.05, decay_mask="all"), 1e-3),
    "lars": (lambda m: m.LARS(momentum=0.9, weight_decay=5e-4), 0.5),
    "lamb": (lambda m: m.LAMB(weight_decay=0.01), 1e-2),
}
MODELS = {
    "resnet": (lambda: resnet.ResNet("basic", (1, 1, 1, 1), 10, widths=(8, 16, 32, 64),
                                     device="cpu", seed=0),
               "fc.weight", "stage2.0.conv1.weight"),
    "vit": (lambda: vit.vit_tiny(device="cpu", seed=0), "head.weight", "blocks.0.mlp1.weight"),
}


def _to_jax(model, sd):
    """``{parameter name: array}`` -> the JAX parameter pytree."""
    if isinstance(model, resnet.ResNet):
        return bridge.resnet_state_dict_to_jax(sd)[0]
    return bridge.vit_state_dict_to_jax(sd)


def _from_jax(model, tree):
    if isinstance(model, resnet.ResNet):
        return bridge.resnet_state_dict_from_jax(tree)
    return bridge.vit_state_dict_from_jax(tree)


def _setup(model_name):
    """The model with one zero matrix, its JAX-layout parameters, and
    STEPS gradient pytrees (one matrix's gradient zero throughout)."""
    make, zero_param, dead_param = MODELS[model_name]
    model = make()
    with torch.no_grad():
        dict(model.named_parameters())[zero_param].zero_()
    names = [n for n, _ in model.named_parameters()]
    host = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    rng = np.random.default_rng(11)
    grads = []
    for _ in range(STEPS):
        g = {n: (rng.standard_normal(host[n].shape) * 1e-2).astype(np.float32) for n in names}
        g[dead_param] = np.zeros_like(g[dead_param])
        grads.append(g)
    return model, names, host, grads


def _run_port(opt_name, model_name):
    make_opt, lr = OPTIMIZERS[opt_name]
    model, names, host, grads = _setup(model_name)
    opt = make_opt(optim)
    params = list(model.parameters())
    state = opt.init(params)
    for g in grads:
        opt.update([torch.from_numpy(g[n]) for n in names], state, params, lr)
    return model, names, state


def _run_jax(opt_name, model_name):
    make_opt, lr = OPTIMIZERS[opt_name]
    model, names, host, grads = _setup(model_name)
    opt = make_opt(jax_optim)
    params = _to_jax(model, host)
    state = opt.init(params)
    for g in grads:
        params, state = opt.update(_to_jax(model, g), state, params, np.float32(lr))
    return jax.device_get(params), jax.device_get(state)


# f32 on both sides, the same operations in the same order; what differs:
# - the norms of LARS and LAMB sum their squares in another order (XLA's
#   reduction tree vs PyTorch's vectorised one), a few ulps of each norm,
#   so the trust ratio and every update of a leaf move by ~1e-7 relative;
# - XLA may contract a multiply-add into one fused rounding, and the bias
#   corrections' ``b ** count`` comes from two pow implementations: an ulp
#   of a moment or a correction, ~1e-7 relative of an Adam update.
# After five steps the parameters differ by a few ulps of their values
# (at most 7.5e-6 lr absolute here, 3e-6 of the largest change of a leaf
# for AdamW and LAMB); the limit is 1e-5 relative of each value plus 1e-6
# of lr absolute. The moments follow the same arithmetic: 1e-5 relative
# plus 1e-9 absolute (gradients are ~1e-2, second moments ~1e-4).
PARAM_RTOL = 1e-5
MOMENT_TOL = dict(rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("model_name", list(MODELS))
@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
def test_five_steps_match_the_jax_optimizer(opt_name, model_name):
    lr = OPTIMIZERS[opt_name][1]
    model, names, state = _run_port(opt_name, model_name)
    want_params, want_state = _run_jax(opt_name, model_name)
    got = _from_jax(model, want_params)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), got[n], rtol=PARAM_RTOL,
                                   atol=1e-6 * lr, err_msg=n)
    if opt_name == "lars":
        want_mom = _from_jax(model, want_state)
        for n, b in zip(names, state):
            np.testing.assert_allclose(b.numpy(), want_mom[n], **MOMENT_TOL, err_msg=n)
        return
    assert state["count"].dtype == torch.int32 and state["count"].shape == ()
    assert int(state["count"]) == int(want_state["count"]) == STEPS
    for key in ("mu", "nu"):
        want = _from_jax(model, want_state[key])
        for n, t in zip(names, state[key]):
            np.testing.assert_allclose(t.numpy(), want[n], **MOMENT_TOL, err_msg=f"{key} {n}")


@pytest.mark.parametrize("opt_name", ["adamw_auto", "lars", "lamb"])
def test_the_zero_leaves_take_the_fallback_and_move(opt_name):
    """The zero matrix moves (a trust ratio of 1, not 0/0), and nothing
    turns non-finite."""
    model, _, _ = _run_port(opt_name, "resnet")
    fc = dict(model.named_parameters())["fc.weight"]
    assert torch.isfinite(fc).all() and fc.abs().max() > 0
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_the_update_is_in_place():
    """The parameters, moments and count keep their storage: the fused
    epoch's captured graph and the checkpoint restore rely on it."""
    model = MODELS["resnet"][0]()
    params = list(model.parameters())
    for opt in (optim.AdamW(), optim.LAMB(), optim.LARS()):
        state = opt.init(params)
        ptrs = [p.data_ptr() for p in params]
        held = state if isinstance(state, list) else state["mu"] + state["nu"] + [state["count"]]
        held_ptrs = [t.data_ptr() for t in held]
        opt.update([torch.ones_like(p) for p in params], state, params, 0.1)
        assert [p.data_ptr() for p in params] == ptrs
        assert [t.data_ptr() for t in held] == held_ptrs


def test_adamw_refuses_an_unknown_mask():
    with pytest.raises(ValueError, match="decay_mask"):
        optim.AdamW(decay_mask="none")


# the model zoo of both trainers (tests register others, such as a narrow
# ResNet, at run time: the list is fixed here so every worker collects it)
ZOO = ("resnet18", "resnet34", "resnet50", "resnet50_imagenet", "vit_b16", "vit_s16",
       "vit_tiny")


@pytest.mark.parametrize("name", ZOO)
def test_every_leaf_has_the_jax_leafs_rank(name):
    """The rank ≤ 1 rule reads the port's tensor: its rank is the JAX
    package's leaf's for every model of the zoo (shapes only: the JAX
    side is traced, the port's model lives on the meta device)."""
    classes = 10 if name == "vit_tiny" else 100
    md = jax_trainer.build_model(JaxConfig(model=name, num_classes=classes))
    shapes, _ = jax.eval_shape(md.init, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    model = trainer.build_model(TrainConfig(model=name, num_classes=classes), "meta")
    by_name = _from_jax(model, tree)
    ranks = {n: p.dim() for n, p in model.named_parameters()}
    assert ranks == {n: by_name[n].ndim for n in ranks}
