"""The JAX side and the shared inputs of the port's pipeline tests
(``test_torch_pipeline*.py``, ``test_torch_vit_pp.py``): the toy stage of
the JAX package's own pipeline tests inside ``shard_map`` over a ``pipe``
mesh (jitted, forward and gradients in one program), the pipelined ViT of
``tests/test_pipeline_parallel_training.py`` with its weights (numpy, in
each layout's storage order) and the JAX steps
on the 8 CPU devices. The gloo ranks import only ``torch_ranks``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from model_parallel_jax import jax_run, mesh_of

from tpu_dist.comm.compat import shard_map
from tpu_dist.nn.vit_pp import ViTPipelineDef
from tpu_dist.parallel.pipeline import pipeline_apply, pipeline_apply_interleaved
from tpu_dist_torch import bridge
from tpu_dist_torch.nn import vit

# tests/test_pipeline_parallel_training.py's model: 4 blocks, 4 chunks at pp 2 x v 2
PP_KW = dict(image_size=16, patch_size=4, dim=32, depth=4, heads=4, num_classes=5)


def pp_model(interleave=1, pp_stages=0):
    return ViTPipelineDef(**PP_KW, interleave=interleave, pp_stages=pp_stages)


@functools.lru_cache(maxsize=None)
def _logical_params():
    return bridge.numpy_vit_params(vit.ViT(**PP_KW, device="cpu"), seed=0)


def pp_params(interleave=1, pp_stages=0):
    """``pp_model``'s weights, numpy, drawn from numpy seed 0 in
    ``ViTPipelineDef.init``'s distributions (``bridge.numpy_vit_params``):
    the blocks stacked in the layout's storage order."""
    tree = _logical_params()
    perm = pp_model(interleave, pp_stages)._storage_perm()
    rows = tree["blocks"] if perm is None else [tree["blocks"][i] for i in perm]
    stacked = jax.tree_util.tree_map(lambda *leaves: np.stack(leaves), *rows)
    return {**{k: v for k, v in tree.items() if k != "blocks"}, "blocks": stacked}


def toy_inputs(n_virtual, n_micro=4, b=2, d=6, seed=1):
    """The toy pipeline's weights ``[n_virtual, d, d]`` (virtual stages in
    logical order), microbatches ``[M, b, d]`` and output cotangent."""
    rng = np.random.default_rng(seed)
    ws = (rng.normal(size=(n_virtual, d, d)) * 0.3).astype(np.float32)
    x = rng.normal(size=(n_micro, b, d)).astype(np.float32)
    ct = rng.normal(size=(n_micro, b, d)).astype(np.float32)
    return ws, x, ct


def toy_jax(ws, x, ct, n, v):
    """JAX's pipeline of ``tanh(h @ w)`` over ``n`` devices, GPipe at ``v ==
    1`` else interleaved: the output and each device's gradient of ``<out,
    ct>`` (per-device loss replicas, the JAX tests' convention) for its
    ``[v, d, d]`` chunk weights."""
    mesh = mesh_of([n], ["pipe"])
    # device d holds virtual stages d, d + n, ...: [n, v, d, d], device-major
    local = np.stack([np.stack([ws[k * n + dev] for k in range(v)]) for dev in range(n)])

    def stage(w, h):
        return jnp.tanh(h @ w)

    def per_device(w_l, xm, c):
        def loss(w):
            if v == 1:
                out = pipeline_apply(stage, w[0], xm, "pipe", n)
            else:
                out = pipeline_apply_interleaved(stage, w, xm, "pipe", n, v)
            return jnp.sum(out * c), out

        (_, out), g = jax.value_and_grad(loss, has_aux=True)(w_l[0])
        return out, g[None]

    fn = jax.jit(shard_map(per_device, mesh=mesh, in_specs=(P("pipe"), P(), P()),
                           out_specs=(P(), P("pipe")), check_vma=False))
    out, g = fn(local, x, ct)
    return np.asarray(out), np.asarray(g)


def pp_jax_run(batch_list, shape, names, interleave=1, n_micro=0, **kw):
    """The JAX step of the pipelined ViT on the ``shape``/``names`` mesh
    (``pipe`` and, for PP×TP, ``model``), its leaves placed by the layout's
    specs, from :func:`pp_params`: (losses, final params numpy)."""
    pp = shape[list(names).index("pipe")]
    md = pp_model(interleave, pp if interleave > 1 else 0)
    specs = (md.pp_tp_param_specs("pipe", "model") if "model" in names
             else md.pp_param_specs("pipe"))
    return jax_run(md, pp_params(interleave, pp if interleave > 1 else 0),
                   mesh_of(shape, names), batch_list, specs=specs, pp_axis="pipe",
                   tp_axis="model" if "model" in names else None,
                   model_kwargs={"n_microbatches": n_micro} if n_micro else None, **kw)
