"""The port's training path (``tpu_dist_torch.train``: ``make_train_step``,
``make_eval_step``, ``TrainState``, ``SGD``; the flash backward and the fused
SGD under them) held against the JAX package's ``make_train_step`` and
``make_eval_step`` on a one-device mesh.

``vit_tiny`` (2 blocks, dim 64, 4 heads, 64 tokens, 10 classes) with weights
from numpy seed 0 carried to both sides through the bridge; batches from a
numpy seed. The JAX step runs its flash attention and fused SGD in Pallas
interpret mode; the port runs their plain versions on the CPU. Gradient
accumulation, label smoothing, clipping and bf16 are in
``test_torch_train_step_variants.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.nn import functional as jax_F
from tpu_dist.nn import vit as jax_vit
from tpu_dist.train import optim as jax_optim
from tpu_dist.train import state as jax_state
from tpu_dist.train import step as jax_step
from tpu_dist_torch import bridge
from tpu_dist_torch.comm.mesh import AxisGroup
from tpu_dist_torch.nn import functional as F
from tpu_dist_torch.nn import vit
from tpu_dist_torch.serve.engine import ServingEngine
from tpu_dist_torch.train import optim, state, step

BATCH = 8
LRS = (0.1, 0.1, 0.05)

# f32 on both sides, the same function in another summation order (XLA's
# fused dots vs PyTorch's matmuls, 128-row Pallas tiles vs whole rows): the
# losses (~2.3) agree to a few ulps, and after three SGD steps at lr <= 0.1
# every weight and momentum entry (|w| up to ~2, |b| up to ~1) to ~1e-6.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=2e-6)


def jax_setup(seed=0, fused=True, **step_kw):
    """(JAX step, JAX state, port model, numpy weights) from one seed."""
    model = vit.vit_tiny(attn_impl="flash", device="cpu")
    params = bridge.numpy_vit_params(model, seed=seed)
    bridge.load_jax_vit(model, params)
    mesh = mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS], jax.devices()[:1])
    md = jax_vit.vit_tiny()
    opt = jax_optim.SGD(momentum=0.9, weight_decay=1e-4, fused=fused)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax.device_put(jax_state.TrainState.create(jparams, {}, opt),
                            mesh_lib.replicated(mesh))
    jstep = jax_step.make_train_step(md.apply, opt, mesh, donate=False,
                                     model_kwargs={"attn_impl": "flash"}, **step_kw)
    return jstep, jstate, model, mesh


def batch(seed, n=BATCH):
    rng = np.random.default_rng(100 + seed)
    return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def assert_state_close(tstate, jstate, tol=PARAM_TOL):
    ours = bridge.vit_params_to_jax(tstate.params)
    mom = bridge.sgd_state_to_jax(tstate.params, tstate.opt_state)
    for got, want in ((ours, jstate.params), (mom, jstate.opt_state)):
        got_l, want_l = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert len(got_l) == len(want_l)
        for a, b in zip(got_l, want_l):
            np.testing.assert_allclose(a, np.asarray(b), **tol)


def test_three_flash_fused_steps_match_jax():
    jstep, jstate, model, _ = jax_setup()
    tstate = state.TrainState.create(model, optim.SGD(fused=True))
    tstep = step.make_train_step(optim.SGD(fused=True))
    for i, lr in enumerate(LRS):
        x, y = batch(i)
        jstate, jm = jstep(jstate, x, y, lr)
        tstate, tm = tstep(tstate, x, y, lr)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **LOSS_TOL)
        # f32 logits a few ulps apart: the same classes rank first
        assert tm["acc1"].item() == float(jm["acc1"])
        assert tm["acc5"].item() == float(jm["acc5"])
    assert tstate.step == 3 and int(jstate.step) == 3
    assert tstate.bn_state == {} and tstate.ef == ()
    assert_state_close(tstate, jstate)


def test_eval_step_with_mask_matches_jax():
    jstep, jstate, model, mesh = jax_setup(seed=1)
    tstate = state.TrainState.create(model, optim.SGD())
    x, y = batch(7)
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32)  # two padded examples
    md = jax_vit.vit_tiny()
    jsums = jax_step.make_eval_step(md.apply, mesh, model_kwargs={"attn_impl": "flash"})(
        jstate, x, y, mask)
    tsums = step.make_eval_step()(tstate, x, y, mask)
    assert set(tsums) == {"loss", "top1", "top5", "count"}
    np.testing.assert_allclose(tsums["loss"].item(), float(jsums["loss"]), **LOSS_TOL)
    for k in ("top1", "top5", "count"):
        assert tsums[k].item() == float(jsums[k]), k
    assert tsums["count"].item() == 6.0
    assert model.training  # the eval step leaves the model's mode as it was


# tp_axis, ep_axis and pp_axis, ported with tensor, expert and pipeline
# parallelism (they raised NotPortedError before): a model group of one
# with no process group (the multi-rank parity is
# tests/test_torch_tensor_parallel*.py, test_torch_expert_parallel.py and
# test_torch_pipeline*.py)
MODEL_AXES = [("tp_axis", "model"), ("ep_axis", "expert"), ("pp_axis", "pipe")]

# The options ported with ZeRO-1 and the compressed reduce, each stepping
# at one device (no process group): there ZeRO-1 is the plain step bit for
# bit, in one column group or two; the compressed wires round the reduced
# gradients (tests/test_torch_zero1.py and test_torch_compression.py hold
# them against JAX on 2 ranks).
PORTED = [
    ("shard_weight_update", dict(shard_weight_update=True)),
    ("rs_ag_chunks", dict(shard_weight_update=True, rs_ag_chunks=2)),
    ("grad_compression=bf16", dict(grad_compression="bf16")),
    ("grad_compression=int8_ef", dict(grad_compression="int8_ef")),
]


@pytest.mark.parametrize("name,kw", PORTED, ids=[n for n, _ in PORTED])
def test_ported_flags_step_at_one_device(name, kw):
    models = [vit.vit_tiny(device="cpu") for _ in range(2)]
    for m in models:
        bridge.load_jax_vit(m, bridge.numpy_vit_params(m, seed=0))
    opt = optim.SGD()
    plain = state.TrainState.create(models[0], opt)
    lay = step.flat_layout(models[1])
    st = state.TrainState.create(models[1], opt)
    if kw.get("shard_weight_update"):
        st.opt_state = step.init_sharded_opt_state(models[1], opt, layout=lay)
        st.layout = lay
    if kw.get("grad_compression") == "int8_ef":
        st.ef, st.layout = step.init_ef_state(models[1], layout=lay), lay
    _, mp = step.make_train_step(opt)(plain, *batch(0), LRS[0])
    st, m = step.make_train_step(opt, **kw)(st, *batch(0), LRS[0])
    assert st.step == 1 and m["loss"].item() == mp["loss"].item()  # the same forward
    pairs = list(zip(models[1].parameters(), models[0].parameters()))
    if kw.get("shard_weight_update"):
        for a, b in pairs:
            assert torch.equal(a, b)
        assert st.opt_state.shape == (lay.chunk,) == (lay.L,)
        return
    # a rounded gradient (bf16: 2^-8 relative; int8: 1/254 of a chunk's
    # largest entry) moves each weight by lr times that, far below 1e-3
    assert any(not torch.equal(a, b) for a, b in pairs)
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    if st.ef:
        assert st.ef["r1"].abs().max() > 0 and st.ef["r2"].shape == (lay.chunk,)


@pytest.mark.parametrize("sp_mode", ["ring", "ulysses"])
def test_seq_axis_steps_at_one_device(sp_mode):
    """``seq_axis`` (ported with sequence parallelism; it raised
    ``NotPortedError`` before) over a seq group of one and no process
    group: nothing is exchanged, so Ulysses runs the plain attention on the
    whole sequence, bit for bit the plain step; the ring's one rotation
    scales its f32 scores by 1/sqrt(D) where the plain chain divides by
    sqrt(D) and merges one block, a few ulps of the loss and the weights
    (multi-rank parity: tests/test_torch_seq_parallel_*.py)."""
    models = [vit.vit_tiny(device="cpu") for _ in range(2)]
    for m in models:
        bridge.load_jax_vit(m, bridge.numpy_vit_params(m, seed=0))
    opt = optim.SGD()
    one = dict(seq_axis=AxisGroup("seq", 1, 0), sp_mode=sp_mode)
    losses = []
    for model, kw in zip(models, ({}, one)):
        st = state.TrainState.create(model, opt)
        st, m = step.make_train_step(opt, **kw)(st, *batch(0), LRS[0])
        assert st.step == 1
        losses.append(m["loss"].item())
    pairs = list(zip(models[1].parameters(), models[0].parameters()))
    if sp_mode == "ulysses":
        assert losses[0] == losses[1] and all(torch.equal(a, b) for a, b in pairs)
        return
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flag,value", MODEL_AXES, ids=[f"{f}={v}" for f, v in MODEL_AXES])
def test_model_axes_step_at_one_device(flag, value):
    """A TP ViT, an EP ViT-MoE or a pipelined ViT over a group of one steps
    as the unsharded model does: the conjugate pair, the exchange and the
    one-stage schedule are identities without a process group, so the loss
    is the same and the weights agree to the einsum's summation order
    (exactly, for TP and PP); a model built without the group is refused,
    as JAX refuses an axis without ``param_specs``."""
    from tpu_dist_torch.nn import vit_moe, vit_pp  # noqa: PLC0415

    axis = AxisGroup(value, 1, 0)
    make = {"tp_axis": lambda **k: vit.vit_tiny(device="cpu", **k),
            "ep_axis": lambda **k: vit_moe.vit_moe_tiny(device="cpu", **k),
            "pp_axis": lambda **k: vit_pp.vit_pp_tiny(device="cpu", **k)}[flag]
    shard = {"tp_axis": {"tp": axis}, "ep_axis": {"ep": axis}, "pp_axis": {"pipe": axis}}[flag]
    models = [make(), make(**shard)]
    opt = optim.SGD()
    losses = []
    for model, kw in zip(models, ({}, {flag: axis})):
        st = state.TrainState.create(model, opt)
        st, m = step.make_train_step(opt, **kw)(st, *batch(0), LRS[0])
        assert st.step == 1
        losses.append(m["loss"].item())
    assert losses[0] == losses[1]
    for a, b in zip(models[1].parameters(), models[0].parameters()):
        exact = flag != "ep_axis"
        torch.testing.assert_close(a, b, rtol=0 if exact else 1e-6, atol=0 if exact else 1e-7)
    with pytest.raises(ValueError, match=f"{flag} requires param_specs"):
        step.make_train_step(opt, **{flag: axis})(state.TrainState.create(make(), opt),
                                                  *batch(0), LRS[0])


def test_per_leaf_gradient_reduce_is_ported():
    """``pmean_fusion="per_leaf"`` (one all-reduce per gradient leaf) is the
    DDP reduce of the data-parallel step now; without a process group it is
    the one-device step, bit for bit the fused one."""
    losses = []
    for fusion in ("fused", "per_leaf"):
        _, _, model, _ = jax_setup()
        tstep = step.make_train_step(optim.SGD(), pmean_fusion=fusion)
        _, m = tstep(state.TrainState.create(model, optim.SGD()), *batch(0), LRS[0])
        losses.append(m["loss"].item())
    assert losses[0] == losses[1]


@pytest.mark.parametrize("kw", [
    {"grad_compression": "fp4"}, {"pmean_fusion": "tree"}, {"rs_ag_chunks": 0},
    {"grad_accum_steps": 0},
], ids=str)
def test_bad_option_values_raise(kw):
    with pytest.raises(ValueError):
        step.make_train_step(optim.SGD(), **kw)


def test_batch_must_split_into_the_accumulation_chunks():
    model = vit.vit_tiny(device="cpu")
    tstep = step.make_train_step(optim.SGD(), grad_accum_steps=3)
    with pytest.raises(ValueError, match="chunks"):
        tstep(state.TrainState.create(model, optim.SGD()), *batch(0), 0.1)


def test_serving_builds_no_autograd_graph(monkeypatch):
    """Now that the flash forward accepts tensors that require grad, only
    inference mode keeps a serving forward from building a graph: every
    dispatch, warmup and pump alike, runs under it."""
    seen = []
    orig = ServingEngine._dispatch

    def spy(self, batch_):
        seen.append(torch.is_inference_mode_enabled())
        out = orig(self, batch_)
        seen.append(out.requires_grad)
        return out

    monkeypatch.setattr(ServingEngine, "_dispatch", spy)
    engine = ServingEngine(vit.vit_tiny(attn_impl="flash", device="cpu"), max_batch=4,
                           device="cpu")
    engine.warmup((32, 32, 3))
    for x in batch(3, n=5)[0]:
        engine.submit(x)
    done = engine.drain()
    assert len(done) == 5 and all(r.ok for r in done)
    assert seen[0::2] == [True] * (len(seen) // 2) and not any(seen[1::2])
    assert len(seen) == 2 * (3 + 2)  # buckets 1, 2, 4 warmed up; batches of 4 and 1


def test_bridge_round_trips_params_and_momentum():
    model = vit.vit_tiny(device="cpu")
    params = bridge.numpy_vit_params(model, seed=3)
    bridge.load_jax_vit(model, params)
    back = bridge.vit_params_to_jax(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # a momentum pytree in the JAX layout, through the port's buffers and back
    mom = jax.tree_util.tree_map(lambda a: a * 0.5 + 1.0, params)
    bufs = bridge.sgd_state_from_jax(model, mom)
    names = [n for n, _ in model.named_parameters()]
    assert len(bufs) == len(names)
    assert all(b.shape == p.shape for b, p in zip(bufs, model.parameters()))
    for a, b in zip(jax.tree_util.tree_leaves(bridge.sgd_state_to_jax(model, bufs)),
                    jax.tree_util.tree_leaves(mom)):
        np.testing.assert_array_equal(a, b)
    # the JAX optimizer's own zero state has the same layout
    zeros = jax_optim.SGD().init(jax.tree_util.tree_map(jnp.asarray, params))
    assert all(float(b.abs().sum()) == 0.0
               for b in bridge.sgd_state_from_jax(model, jax.tree_util.tree_map(np.asarray, zeros)))


def test_bridge_back_and_momentum_reject_bad_keys():
    model = vit.vit_tiny(device="cpu")
    params = bridge.numpy_vit_params(model, seed=0)
    with pytest.raises(KeyError, match="unknown"):
        bridge.sgd_state_from_jax(model, dict(params, cls=np.zeros(3, np.float32)))
    with pytest.raises(KeyError, match="missing"):
        bridge.sgd_state_from_jax(model, dict(params, blocks=params["blocks"][:1]))
    with pytest.raises(ValueError, match="head.weight"):
        bridge.sgd_state_from_jax(vit.vit_tiny(num_classes=7, device="cpu"), params)
    with pytest.raises(KeyError, match="momentum buffers"):
        bridge.sgd_state_to_jax(model, [torch.zeros(1)])
    sd = {n: t.numpy() for n, t in model.state_dict().items()}
    with pytest.raises(KeyError, match="unknown"):
        bridge.vit_state_dict_to_jax(dict(sd, extra=np.zeros(1)))
    del sd["head.bias"]
    with pytest.raises(KeyError, match="missing"):
        bridge.vit_state_dict_to_jax(sd)


@pytest.mark.parametrize("smoothing", (0.0, 0.1))
@pytest.mark.parametrize("reduction", ("mean", "sum", "none"))
def test_cross_entropy_matches_jax(reduction, smoothing):
    rng = np.random.default_rng(9)
    logits = (rng.standard_normal((16, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    want = jax_F.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               reduction=reduction, label_smoothing=smoothing)
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          reduction=reduction, label_smoothing=smoothing)
    assert got.dtype == torch.float32
    # the same f32 log-softmax in another order: a few ulps of |loss| ~ 50
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_cross_entropy_is_f32_for_bf16_logits_and_refuses_unknown_reduction():
    logits = torch.randn(4, 10, generator=torch.Generator().manual_seed(0)).bfloat16()
    labels = torch.tensor([1, 2, 3, 4])
    assert F.cross_entropy(logits, labels).dtype == torch.float32
    with pytest.raises(ValueError, match="reduction"):
        F.cross_entropy(logits, labels, reduction="avg")


@pytest.mark.parametrize("classes", (10, 3))
def test_topk_correct_and_accuracy_match_jax(classes):
    """f32 logits with no ties, so both top-k orders agree (torch.topk and
    lax.top_k may break ties differently). Three classes clamp k = 5."""
    rng = np.random.default_rng(classes)
    logits = rng.standard_normal((32, classes)).astype(np.float32)
    labels = rng.integers(0, classes, 32).astype(np.int32)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    got = F.topk_correct(tl, ty, (1, 5))
    want = jax_F.topk_correct(jl, jy, (1, 5))
    assert [int(g) for g in got] == [int(w) for w in want]
    got_acc = F.accuracy(tl, ty, (1, 5))
    want_acc = jax_F.accuracy(jl, jy, (1, 5))
    np.testing.assert_allclose([float(g) for g in got_acc], [float(w) for w in want_acc],
                               rtol=1e-6)


def test_fused_sgd_takes_channels_last_gradients_without_a_process_group():
    """The ResNets feed channels-last activations, so the convolutions hand
    back channels-last (non-contiguous) weight gradients; without a process
    group no flat all-reduce makes them contiguous, and the fused update
    refuses anything else. The step makes them contiguous itself."""
    from tpu_dist_torch.nn import resnet  # noqa: PLC0415

    x, y = batch(0)
    params = []
    for fused in (True, False):
        model = resnet.ResNet("basic", (1, 1, 1, 1), 10, widths=(8, 16, 32, 64), device="cpu")
        st = state.TrainState.create(model, optim.SGD(fused=fused))
        st, m = step.make_train_step(optim.SGD(fused=fused))(st, x, y, 0.1)
        assert np.isfinite(m["loss"].item())
        params.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*params):  # the fused update is the plain one, bit for bit
        torch.testing.assert_close(a, b, rtol=0, atol=0)
