"""FSDP in the port (``parallel/fsdp.py``) held to the JAX package's
(``tpu_dist/parallel/fsdp.py``): the spec rules equal JAX's on the same
shapes, each torch dimension chosen is JAX's axis, and the step matches
the port's plain data-parallel step and JAX's ``make_fsdp_train_step``
leaf by leaf at 2 data ranks (2 gloo ranks; JAX on 2 CPU devices, so the
chunks of an accumulated step hold the same rows), with BatchNorm, grad
accumulation, clipping, label smoothing and ``remat``, under SGD and LARS,
to ``tests/test_fsdp.py:92-101``'s bounds (rtol 1e-5, atol 1e-6) against
the plain step, and to the plain steps' cross-package bounds against JAX
(``fsdp_jax.JAX_TOL``: PyTorch's convolutions and matmuls sum in another
order than XLA's). The lockstep group of one process matches the gloo
group, and the state and the memory ledger hold a rank's shards only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from fsdp_jax import (JAX_TOL, assert_close_flats, batches, init_flat, jax_fsdp_run,
                      port_model)
from jax.sharding import PartitionSpec as P
from torch_ranks import fsdp_step_rank, run_ranks

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.parallel import fsdp as jax_fsdp
from tpu_dist_torch import bridge
from tpu_dist_torch.comm import mesh
from tpu_dist_torch.obs import counters, memory
from tpu_dist_torch.parallel import fsdp
from tpu_dist_torch.train.optim import SGD
from tpu_dist_torch.train.state import TrainState

SHAPES = {
    "big_div": (3, 3, 16, 64),     # 64 % 8 == 0 -> sharded dim 3
    "big_lead": (256, 5),          # 256 % 8 == 0 -> sharded dim 0
    "big_nodiv": (9, 121),         # no dim divisible by 8
    "small": (64,),                # below min_size
    "scalar": (),
    "tie": (3, 3, 64, 64),         # ties toward the leading dim
}


def _jax_specs(tree, n, **kw):
    mesh = mesh_lib.device_mesh([n], ["data"], jax.devices()[:n])
    return jax.tree_util.tree_map(tuple, jax_fsdp.fsdp_specs(tree, mesh, **kw),
                                  is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("min_size", [64, 1024])
def test_fsdp_specs_equal_jaxs(n, min_size):
    tree = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    tree["models"] = {"resnet": bridge.jax_layout_template(port_model("dp"))[0],
                      "vit": bridge.jax_layout_template(port_model("vit"))[0]}
    port = fsdp.fsdp_specs(jax.tree_util.tree_map(np.asarray, tree), n, min_size=min_size)
    assert port == _jax_specs(tree, n, min_size=min_size)
    if n == 8:
        assert port["big_div"] == (None, None, None, "data")
        assert port["big_lead"] == ("data", None) and port["big_nodiv"] == ()
        assert port["tie"] == (None, None, "data", None)


@pytest.mark.parametrize("model", ["dp", "vit"])
def test_each_torch_dim_holds_jaxs_axis(model):
    """A rank's shard along the torch dimension chosen is JAX's device
    window along its axis: cut the torch weight, lay it out as JAX, and it
    is the JAX array's block."""
    m = port_model(model)
    dims = fsdp.fsdp_dims(m, 4, min_size=64)
    layout = bridge.leaf_layout(m)
    jax_tree = bridge.keystr_leaves(bridge.resnet_params_to_jax(m)[0] if model == "dp"
                                    else bridge.vit_params_to_jax(m))
    specs = fsdp.fsdp_specs(jax_tree, 4, min_size=64)
    assert dims and len(dims) == sum("data" in s for s in specs.values())
    for name, p in m.named_parameters():
        lay = layout[name]
        if name not in dims:
            assert "data" not in specs[lay.key]
            continue
        j = specs[lay.key].index("data")
        assert lay.perm[j] == dims[name]
        full = jax_tree[lay.key]
        size = full.shape[j] // 4
        for r in range(4):
            cut = p.detach().narrow(dims[name], r * size, size).numpy().transpose(lay.perm)
            want = np.take(full, range(r * size, (r + 1) * size), axis=j)
            np.testing.assert_array_equal(cut, want, err_msg=name)


def test_the_state_holds_a_ranks_shards_and_the_ledger_counts_them():
    opt = SGD()
    st = fsdp.shard_state(TrainState.create(port_model("dp"), opt), lockstep=4, optimizer=opt)
    fs = st.fsdp
    whole = sum(p.numel() for p in fs.params) * 4
    sharded = sum(fs.params[i].numel() * 4 for i in range(len(fs.dims)) if fs.sharded(i))
    assert fs.shard_bytes(0) == whole - sharded + sharded // 4
    # between steps a sharded parameter holds no data of its own
    assert all(p.data.stride() == (0,) * p.dim() for i, p in enumerate(fs.params)
               if fs.sharded(i))
    with fs.gathered():
        assert all(p.is_contiguous() for p in fs.params)
    one = fsdp.shard_state(TrainState.create(port_model("dp"), opt), lockstep=1, optimizer=opt)
    plain = memory.static_ledger(**memory.state_sections(one))["sections"]["params"]
    ledger = memory.static_ledger(**memory.state_sections(fsdp.shard_state(
        TrainState.create(port_model("dp"), opt), axis=mesh.AxisGroup("data", 4, 0),
        optimizer=opt)))["sections"]
    assert plain["sharded_leaves"] == 0
    assert ledger["params"]["sharded_leaves"] == sum(fs.sharded(i) for i in range(len(fs.dims)))
    assert ledger["params"]["bytes_per_device"] == fs.shard_bytes(0)
    assert ledger["opt_state"]["bytes_per_device"] == fs.shard_bytes(0)
    assert ledger["params"]["bytes_total"] == plain["bytes_total"]


CASES = {
    # BatchNorm (SyncBN over the group: GSPMD's global batch), remat
    "sgd-bn-remat": dict(model="dp", opt="SGD", flat="dp-SGD", kw=dict(remat=True)),
    # the hard case: BatchNorm + accumulation (JAX's chunk order), the
    # global-norm clip, label smoothing
    "lars-accum-clip": dict(model="dp", opt="LARS", flat="dp-LARS",
                            kw=dict(grad_accum_steps=2, grad_clip_norm=0.5,
                                    label_smoothing=0.1)),
}


@pytest.fixture(scope="module")
def runs():
    flats = {f"{c['model']}-{c['opt']}": init_flat(c["model"], c["opt"]) for c in CASES.values()}
    port = run_ranks(fsdp_step_rank, 2, list(CASES.values()), flats, batches("dp"),
                     timeout=120)[0]
    return flats, dict(zip(CASES, port))


@pytest.mark.parametrize("name", list(CASES))
def test_the_fsdp_step_is_the_plain_step(runs, name):
    (plain_losses, fsdp_losses), plain, sharded = runs[1][name]
    np.testing.assert_allclose(fsdp_losses, plain_losses, rtol=1e-5)
    assert_close_flats(sharded, plain, f"{name}: FSDP vs plain")


@pytest.mark.parametrize("name", list(CASES))
def test_the_fsdp_step_is_jaxs(runs, name):
    flats, port = runs
    c = CASES[name]
    losses, want = jax_fsdp_run(c["model"], flats[c["flat"]], batches("dp"), 2, opt=c["opt"],
                                **c["kw"])
    (_, fsdp_losses), _, sharded = port[name]
    np.testing.assert_allclose(fsdp_losses, losses, rtol=1e-5)
    assert_close_flats(sharded, want, f"{name}: port FSDP vs JAX FSDP", tol=JAX_TOL)


def test_a_lockstep_group_is_the_gloo_groups(runs):
    """The lockstep group of 2 virtual ranks in one process, on the global
    batch, takes the gloo group's step (the ResNet's BatchNorm is the
    global batch's in both)."""
    flats, port = runs
    c = CASES["sgd-bn-remat"]
    opt = SGD()
    st = bridge.load_train_state(
        fsdp.shard_state(TrainState.create(port_model("dp", 5), opt), lockstep=2, optimizer=opt),
        flats[c["flat"]])
    step = fsdp.make_fsdp_train_step(opt, **c["kw"])
    counters.reset()
    for images, labels, lr in batches("dp"):
        st, m = step(st, images, labels, lr)
    assert counters.get("comm.all_gather.fsdp_params") == 2 * sum(
        st.fsdp.sharded(i) for i in range(len(st.fsdp.dims)))
    assert_close_flats(bridge.train_state_to_flat(st), port["sgd-bn-remat"][2], "lockstep")


def test_a_compressed_wire_is_refused_with_jaxs_message():
    with pytest.raises(ValueError) as port:
        fsdp.make_fsdp_train_step(SGD(), grad_compression="bf16")
    mesh = mesh_lib.device_mesh([1], ["data"], jax.devices()[:1])
    with pytest.raises(ValueError) as jax_err:
        jax_fsdp.make_fsdp_train_step(lambda *a, **k: None, None, mesh, {},
                                      grad_compression="bf16")
    assert str(port.value) == str(jax_err.value)
