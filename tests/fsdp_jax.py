"""The JAX side and the shared inputs of the port's FSDP and sharded
checkpoint tests (``test_torch_fsdp*.py``, ``test_torch_sharded_ckpt.py``,
``test_torch_async_sharded_ckpt.py``): the states of four layouts as the
flat ``{keystr: array}`` of a checkpoint, their JAX ``TrainState`` on the 8
CPU devices (placed as the JAX package places each layout) and its sharded
save and restore. The gloo ranks import only ``torch_ranks``.

The layouts: ``dp`` (every leaf replicated), ``fsdp`` (``fsdp_specs`` over
the 8 data devices), ``zero1`` (the flat momentum over them) and ``tp``
(Megatron specs on a ``[data 4, model 2]`` mesh).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_dist.ckpt import checkpoint as jax_ckpt
from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.elastic import remap as jax_remap
from tpu_dist.nn.vit import ViTDef
from tpu_dist.parallel import fsdp as jax_fsdp
from tpu_dist.train.state import TrainState as JaxState
from tpu_dist_torch import bridge
from tpu_dist_torch.comm.quantize import padded_len
from tpu_dist_torch.nn import resnet, vit
from tpu_dist_torch.train.optim import SGD
from tpu_dist_torch.train.state import TrainState

NARROW = dict(block="basic", stage_blocks=(1, 1, 1, 1), widths=(8, 16, 32, 64))
TP_KW = dict(image_size=32, patch_size=4, dim=32, depth=2, heads=4, num_classes=5)
KINDS = ("dp", "fsdp", "zero1", "tp")


def port_model(kind, seed=0):
    """The port's model of a layout (on the CPU, unsharded)."""
    if kind in ("tp", "vit"):
        return vit.ViT(**TP_KW, device="cpu", seed=seed)
    return resnet.ResNet(NARROW["block"], NARROW["stage_blocks"], 10, widths=NARROW["widths"],
                         device="cpu", seed=seed)


def params_len(kind) -> int:
    return sum(p.numel() for p in port_model(kind).parameters())


def global_flat(kind, seed=0, n=8) -> dict:
    """A layout's state as a checkpoint's flat dict: the model's weights
    from ``seed`` and random momentum (and BN statistics) from numpy; the
    ZeRO-1 momentum a flat JAX-order vector padded for ``n`` ranks."""
    flat = bridge.train_state_to_flat(TrainState.create(port_model(kind, seed), SGD()))
    rng = np.random.default_rng(seed + 100)
    out = {}
    for k, v in flat.items():
        if k.startswith(("['opt_state']", "['bn_state']")) and v.dtype == np.float32:
            v = rng.standard_normal(v.shape).astype(np.float32)
            if k.endswith("['var']"):
                v = np.abs(v) + 0.5
        out[k] = v
    out["['step']"] = np.asarray(seed + 3, np.int32)
    if kind == "zero1":
        L = params_len(kind)
        vec = np.zeros(padded_len(L, n), np.float32)
        vec[:L] = rng.standard_normal(L).astype(np.float32)
        out = {k: v for k, v in out.items() if not k.startswith("['opt_state']")}
        out["['opt_state']"] = vec
    return out


def init_flat(kind, opt="SGD", seed=0) -> dict:
    """A layout's fresh state under the port optimizer ``opt`` (zero
    moments) as a checkpoint's flat dict; the ResNet's weights are
    ``ResNetDef.init``'s (as ``tests/test_torch_dp_step.py`` draws them: its
    residual branches start at zero, so a step's gradients are not the
    rounding-sensitive ones of a random deep stack)."""
    from tpu_dist_torch.train import optim  # noqa: PLC0415

    model = port_model(kind, seed)
    if kind not in ("tp", "vit"):
        bridge.load_jax_resnet(model, *_jax_resnet_init(seed))
    return bridge.train_state_to_flat(TrainState.create(model, getattr(optim, opt)()))


@functools.lru_cache(maxsize=None)
def _jax_resnet_init(seed):
    from tpu_dist.nn.resnet import ResNetDef  # noqa: PLC0415

    md = ResNetDef(NARROW["block"], NARROW["stage_blocks"], 10, widths=NARROW["widths"])
    return jax.tree_util.tree_map(np.asarray, jax.jit(md.init)(jax.random.PRNGKey(seed)))


def relaid(flat: dict, kind: str, n: int) -> dict:
    """``flat`` with the ZeRO-1 vector laid out for ``n`` ranks (the same
    prefix, the zero tail cut or grown)."""
    if kind != "zero1":
        return flat
    L = params_len(kind)
    vec = np.zeros(padded_len(L, n), np.float32)
    vec[:L] = flat["['opt_state']"][:L]
    return {**flat, "['opt_state']": vec}


def _mesh(kind):
    if kind == "tp":
        return mesh_lib.device_mesh([4, 2], ["data", "model"], jax.devices()[:8])
    return mesh_lib.data_parallel_mesh()


def jax_state(kind, flat: dict) -> JaxState:
    """The JAX ``TrainState`` of ``flat``, placed on the 8 CPU devices as
    the JAX package places the layout."""
    tree = bridge.keystr_unflatten(flat)
    mesh = _mesh(kind)
    params = tree["params"]
    if kind == "fsdp":
        specs = jax_fsdp.fsdp_specs(params, mesh)
    elif kind == "tp":
        specs = ViTDef(**TP_KW).tp_param_specs("model")
    else:
        specs = None

    def place(t, sp):
        if sp is None:
            return jax.tree_util.tree_map(
                lambda a: jax.device_put(jnp.asarray(a), mesh_lib.replicated(mesh)), t)
        return jax.tree_util.tree_map(
            lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)), t, sp,
            is_leaf=lambda x: isinstance(x, P))

    opt = (jax.device_put(jnp.asarray(tree["opt_state"]), NamedSharding(mesh, P("data")))
           if kind == "zero1" else place(tree["opt_state"], specs))
    return JaxState(params=place(params, specs), bn_state=place(tree.get("bn_state", {}), None),
                    opt_state=opt, step=place(tree["step"], None))


def jax_flat(state: JaxState) -> dict:
    """A JAX ``TrainState`` as the flat dict of host arrays."""
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(state._asdict())[0]}


def jax_save(kind, d, flat, epoch=0):
    """The JAX package's sharded save of ``flat`` in layout ``kind``."""
    st = jax_state(kind, flat)
    meta = {"elastic": {"dp": 8, "procs": 1, "params_len": params_len(kind)}}
    return jax_ckpt.save_sharded(d, st, epoch, extra_meta=meta)


def jax_restore(kind, mpath) -> dict:
    """The JAX package's ``restore_sharded`` of ``mpath`` onto a template of
    layout ``kind`` on the 8 CPU devices (through its elastic remapper),
    as a flat dict."""
    template = jax_state(kind, global_flat(kind, seed=9))
    meta = jax_ckpt.read_sharded_meta(mpath)
    remap = jax_remap.make_remapper(template, meta, 8)
    return jax_flat(jax_ckpt.restore_sharded(mpath, template, remap=remap))


def assert_flat_equal(got: dict, want: dict, kind: str, what: str):
    """Equal arrays key by key; ZeRO-1's vector on its ``L`` prefix (its
    zero tail follows the extent) and zero past it."""
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    L = params_len(kind)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if kind == "zero1" and k == "['opt_state']":
            np.testing.assert_array_equal(a[:L], b[:L], err_msg=f"{what}: {k}")
            assert not a[L:].any() and not b[L:].any(), f"{what}: {k} tail"
            continue
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


# -- the FSDP step -----------------------------------------------------------------

# tests/test_fsdp.py:92-101's bounds for the FSDP step against the plain
# one: the port's FSDP step against the port's plain step
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# The port's step against JAX's: the same math in another summation order
# (PyTorch's CPU convolutions and matmuls vs XLA's), as the plain steps of
# the two packages differ (tests/test_torch_dp_step.py's STATE_TOL): a few
# ulps of the gradients, carried by two steps into weights and momentum of
# sizes up to ~3 (LARS's trust ratios and the clip's scale divide by norms
# of those gradients, which moves an entry by up to ~2e-6)
JAX_TOL = dict(rtol=2e-5, atol=5e-6)


def batches(model, n=16, steps=2, seed=0, lr=0.1):
    """``steps`` global batches ``(images, labels, lr)`` of a layout's
    model."""
    rng = np.random.default_rng(seed)
    size, classes = (32, 5) if model in ("vit", "tp") else (32, 10)
    return [(rng.standard_normal((n, size, size, 3)).astype(np.float32),
             rng.integers(0, classes, n).astype(np.int32), lr) for _ in range(steps)]


def jax_fsdp_run(model, flat, batch_list, n, *, tp=1, opt="SGD", min_size=1024, lr=None,
                 **kw):
    """JAX's ``make_fsdp_train_step`` of a layout's model from ``flat`` on
    ``n`` data devices (``[n, tp]`` as ``[data, model]`` under
    ``compose_fsdp_specs``; ``lr`` overrides the batches'): (losses, the
    final state as a flat dict)."""
    from tpu_dist.nn.resnet import ResNetDef  # noqa: PLC0415
    from tpu_dist.train import optim as jax_optim  # noqa: PLC0415

    if tp > 1:
        mesh = mesh_lib.device_mesh([n, tp], ["data", "model"], jax.devices()[:n * tp])
    else:
        mesh = mesh_lib.device_mesh([n], ["data"], jax.devices()[:n])
    md = (ResNetDef(NARROW["block"], NARROW["stage_blocks"], 10, widths=NARROW["widths"])
          if model == "dp" else ViTDef(**TP_KW))
    tree = bridge.keystr_unflatten(flat)
    params = tree["params"]
    if tp > 1:
        specs = jax_fsdp.compose_fsdp_specs(params, mesh, md.tp_param_specs("model"),
                                            min_size=min_size)
    else:
        specs = jax_fsdp.fsdp_specs(params, mesh, min_size=min_size)
    o = getattr(jax_optim, opt)()
    opt_specs = o.state_specs(specs)
    state = JaxState(params=mesh_lib.place_host_tree(mesh, params, specs),
                     bn_state=mesh_lib.place_host_tree(mesh, tree.get("bn_state", {})),
                     opt_state=mesh_lib.place_host_tree(mesh, tree["opt_state"], opt_specs),
                     step=mesh_lib.place_host_tree(mesh, tree["step"]))
    step = jax_fsdp.make_fsdp_train_step(md.apply, o, mesh, specs, opt_specs=opt_specs,
                                         donate=False, **kw)
    losses = []
    for x, y, batch_lr in batch_list:
        state, m = step(state, mesh_lib.shard_batch(mesh, x), mesh_lib.shard_batch(mesh, y),
                        batch_lr if lr is None else lr)
        losses.append(float(m["loss"]))
    return losses, jax_flat(state)


def _no_key_bias(key: str, a: np.ndarray, heads: int) -> np.ndarray:
    """A ViT's qkv bias (and its moments) without its key part, whose
    gradient is 0 in exact arithmetic: Adam's update there is the sign of
    rounding noise (``chip_smoke.py::_key_bias_masks``)."""
    if key.endswith("['qkv']['b']"):
        return a.reshape(heads, 3, -1)[:, [0, 2], :]
    return a


def assert_close_flats(got: dict, want: dict, what: str, tol=STEP_TOL, heads=None):
    """Every array of ``want`` within ``tol`` in ``got`` (with ``heads``,
    a ViT's key biases left out and held finite)."""
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")
            continue
        assert np.isfinite(a).all(), f"{what}: {k} not finite"
        if heads is not None:
            a, b = _no_key_bias(k, a, heads), _no_key_bias(k, b, heads)
        np.testing.assert_allclose(a, b, **tol, err_msg=f"{what}: {k}")
