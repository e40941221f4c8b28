"""The JAX side and the shared inputs of the port's ZeRO-1 x SP tests
(``test_torch_zero1_sp_ckpt.py``, ``test_torch_zero1_sp_fit.py``): the
state of ``vit_tiny`` with ZeRO-1's flat optimizer state (SGD's momentum,
AdamW's ``mu``/``nu``/``count``) as a checkpoint's flat dict, its JAX
``TrainState`` on a ``[data, seq]`` CPU mesh (the flat vectors sharded
over ``data``, replicated over ``seq``, as ``init_sharded_opt_state``
places them), and the JAX package's saves and restores of it in both
formats. The gloo ranks import only ``torch_ranks``.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_dist.ckpt import checkpoint as jax_ckpt
from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.elastic import remap as jax_remap
from tpu_dist.train.state import TrainState as JaxState
from tpu_dist_torch import bridge
from tpu_dist_torch.comm.quantize import padded_len
from tpu_dist_torch.nn import vit
from tpu_dist_torch.train.optim import SGD
from tpu_dist_torch.train.state import TrainState

OPTS = ("SGD", "AdamW")
SEQ = 2


def params_len() -> int:
    return sum(p.numel() for p in vit.vit_tiny(device="cpu").parameters())


def global_flat(opt: str, n_data: int = 2, seed: int = 0) -> dict:
    """``vit_tiny``'s weights from ``seed`` and ZeRO-1's flat optimizer
    state of ``opt``, random from numpy in the JAX ravel order and padded
    for ``n_data`` data ranks, as a checkpoint's flat dict."""
    base = bridge.train_state_to_flat(TrainState.create(vit.vit_tiny(device="cpu", seed=seed),
                                                        SGD()))
    out = {k: v for k, v in base.items() if not k.startswith("['opt_state']")}
    L = params_len()
    rng = np.random.default_rng(seed + 100)

    def vec():
        v = np.zeros(padded_len(L, n_data), np.float32)
        v[:L] = rng.standard_normal(L).astype(np.float32)
        return v

    if opt == "SGD":
        out["['opt_state']"] = vec()
    else:
        out["['opt_state']['mu']"] = vec()
        out["['opt_state']['nu']"] = np.abs(vec())
        out["['opt_state']['count']"] = np.asarray(seed + 7, np.int32)
    out["['step']"] = np.asarray(seed + 3, np.int32)
    return out


def relaid(flat: dict, n_data: int) -> dict:
    """``flat`` with its flat vectors laid out for ``n_data`` data ranks
    (the same prefix, the zero tail cut or grown)."""
    L = params_len()
    out = dict(flat)
    for k, v in flat.items():
        if k in ("['opt_state']", "['opt_state']['mu']", "['opt_state']['nu']"):
            vec = np.zeros(padded_len(L, n_data), np.float32)
            vec[:L] = v[:L]
            out[k] = vec
    return out


def data_seq_mesh(n_data: int):
    return mesh_lib.device_mesh([n_data, SEQ], [mesh_lib.DATA_AXIS, mesh_lib.SEQ_AXIS],
                                jax.devices()[:n_data * SEQ])


def jax_state(flat: dict, n_data: int = 2) -> JaxState:
    """The JAX ``TrainState`` of ``flat`` on a ``[n_data, 2]`` data x seq
    mesh: the weights and ``step`` replicated, the flat vectors sharded
    over ``data``."""
    tree = bridge.keystr_unflatten(flat)
    mesh = data_seq_mesh(n_data)
    rep = mesh_lib.replicated(mesh)

    def put(a, spec=None):
        return jax.device_put(jnp.asarray(a), rep if spec is None else NamedSharding(mesh, spec))

    opt = tree["opt_state"]
    if isinstance(opt, dict):
        opt = {"mu": put(opt["mu"], P("data")), "nu": put(opt["nu"], P("data")),
               "count": put(opt["count"])}
    else:
        opt = put(opt, P("data"))
    return JaxState(params=jax.tree_util.tree_map(put, tree["params"]), bn_state={},
                    opt_state=opt, step=put(tree["step"]))


def jax_flat(state: JaxState) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(state._asdict())[0]}


def _meta(n_data: int) -> dict:
    return {"elastic": {"dp": n_data, "procs": 1, "params_len": params_len()}}


def jax_save(flat: dict, root: str) -> dict:
    """The JAX package's plain and sharded saves of ``flat`` (laid for 2
    data ranks) from a ``[2, 2]`` mesh: ``{"plain": npz, "sharded":
    manifest}``."""
    st = jax_state(flat)
    return {"plain": jax_ckpt.save(f"{root}/plain", st, 0, extra_meta=_meta(2)),
            "sharded": jax_ckpt.save_sharded(f"{root}/sharded", st, 0, extra_meta=_meta(2))}


def jax_restore(path: str, opt: str, n_data: int = 2) -> dict:
    """The JAX package's restore of ``path`` (a plain ``.npz`` or a sharded
    manifest) onto a ``[n_data, 2]`` template, through its elastic
    remapper: the flat dict."""
    template = jax_state(global_flat(opt, n_data, seed=9), n_data)
    if path.endswith(".manifest.json"):
        meta = jax_ckpt.read_sharded_meta(path)
        remap = jax_remap.make_remapper(template, meta, n_data)
        return jax_flat(jax_ckpt.restore_sharded(path, template, remap=remap))
    remap = jax_remap.make_remapper(template, jax_ckpt.read_meta(path), n_data)
    return jax_flat(jax_ckpt.restore(path, template, remap=remap))


def assert_flat_equal(got: dict, want: dict, what: str):
    """Equal arrays key by key, bit for bit, the flat vectors included."""
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what}: {k}")
