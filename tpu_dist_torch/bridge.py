"""Weights across the two packages, both ways: a JAX parameter pytree (as
numpy arrays, the layout ``ViTDef.init`` / ``ResNetDef.init`` makes) to
and from the port's :class:`~tpu_dist_torch.nn.vit.ViT` or
:class:`~tpu_dist_torch.nn.resnet.ResNet` state dict, and the SGD momentum
pytree (which mirrors the parameters) to and from the port's momentum
buffers, in the model's parameter order.

* Dense ``{"w": [in, out], "b"}`` <-> Linear ``weight [out, in]``, ``bias``;
* LayerNorm ``{"scale", "bias"}`` <-> ``weight``, ``bias``;
* ViT: ``pos`` and ``blocks[i]`` map by name; the ViT-MoE's router
  ``[d, E]`` <-> ``moe.router.weight`` ``[E, d]``, its expert slabs as they
  are;
* ResNet: conv ``{"w": HWIO}`` <-> ``weight`` OIHW; BatchNorm
  ``{"scale", "bias"}`` and its state ``{"mean", "var"}`` <-> ``weight``,
  ``bias``, ``running_mean``, ``running_var``; ``stageK[i]`` <->
  ``stageK.i``.

A whole :class:`~tpu_dist_torch.train.state.TrainState` goes to and from
the flat ``{keystr: array}`` dict that a plain checkpoint holds
(``tpu_dist/ckpt/checkpoint.py::_flatten``): :func:`train_state_to_flat`
and :func:`load_train_state`. Its keys are ``jax.tree_util.keystr`` paths
of the JAX ``TrainState._asdict()`` (``['params']['fc']['w']``,
``['opt_state']['stage1'][0]['conv1']['w']``, ``['step']``), written here
by :func:`keystr_flatten`. AdamW's and LAMB's state crosses as the JAX
dict (``['opt_state']['mu']...``, ``['opt_state']['nu']...``,
``['opt_state']['count']``), so either package resumes the other's run.

The flat parts of a state (``TrainState.layout``: ZeRO-1's optimizer
state, the int8_ef residuals) cross as the JAX package's GLOBAL arrays:
``['opt_state']`` (or ``['opt_state']['mu']``/``['nu']``) of
``ceil(L/n)·n``, ``['ef']['r1']`` of ``n`` rows end to end and
``['ef']['r2']`` of one padded vector, each in the JAX ravel order (the
sorted pytree leaves, each in its JAX layout: :func:`jax_ravel_order`),
where the port keeps the model's parameter order. Each rank holds only
its own shard or row (under ``--sp`` over the data axis, every seq index
of a data row the same), so writing gathers them (every rank must call
:func:`train_state_to_flat` then; with ``dst`` only that rank receives
them and builds the dict), and :func:`load_train_state` takes
this rank's part of each. :func:`restore_template` gives the global
shapes a restore (and its elastic remapper) lays a checkpoint onto.

A tensor- or expert-parallel module (``ViT(tp=)``, ``ViTMoE(ep=)``) holds
this rank's shards: it loads its slices of JAX's full arrays
(:func:`shard_state_dict` by the module's ``param_specs()``), and its
shards, with the optimizer state that mirrors them, are gathered back to
the full layout over its group (:func:`gather_shards`) wherever a JAX
layout is written: every rank of the group must call those functions then.

The pipelined ViT (:class:`~tpu_dist_torch.nn.vit_pp.ViTPipeline`) crosses
as JAX's ``ViTPipelineDef`` tree: ``params["blocks"]`` one dict of stacked
leaves whose leading dimension is the depth in storage order
(:func:`vit_pp_state_dict_from_jax`, :func:`vit_pp_state_dict_to_jax`);
the port's state dict names storage row ``g`` ``blocks.{g}``. A stage holds
``depth / pp`` consecutive rows (``blocks.{i}`` locally, row ``index ·
depth/pp + i``) and, under PP×TP, their Megatron shards: it loads its rows'
slices, and its rows are gathered over its stage group (the joined
``pipe,model`` group under PP×TP), so a checkpoint holds JAX's full stacked
layout.

Under FSDP (``state.fsdp``) the plain format's flatten all-gathers the
shards first, and a load cuts the full leaves into this rank's shards.

The sharded format writes a rank's pieces of the global JAX-layout leaves
(:func:`shard_windows`, :func:`shard_pieces`): for every state-dict entry
the window this rank holds (its TP/EP shard, its stage's stacked rows,
its FSDP shard), permuted into JAX layout by :func:`leaf_layout` (found by
sending index arrays through the converters), with one writer a distinct
piece, as JAX's ``replica_id == 0``; a restore copies each assembled window
back into its live tensor.

An unknown or missing key raises. The pytree is plain nested dicts and
lists of arrays, so this module needs neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import numpy as np
import torch

from tpu_dist_torch.comm import collectives
from tpu_dist_torch.nn.resnet import ResNet
from tpu_dist_torch.nn.vit import ViT
from tpu_dist_torch.nn.vit_moe import ViTMoE
from tpu_dist_torch.nn.vit_pp import ViTPipeline
from tpu_dist_torch.parallel import tensor

_DENSE = ("w", "b")
_LN = ("scale", "bias")
_BLOCK = {"ln1": _LN, "qkv": _DENSE, "proj": _DENSE, "ln2": _LN,
          "mlp1": _DENSE, "mlp2": _DENSE}
_TOP = {"patch": _DENSE, "ln_f": _LN, "head": _DENSE}


def _leaves(where: str, node, want) -> dict:
    if not isinstance(node, dict):
        raise KeyError(f"{where}: expected a dict of {want}, got {type(node).__name__}")
    keys = set(node)
    if keys != set(want):
        raise KeyError(
            f"{where}: keys {sorted(keys)} differ from {sorted(want)} "
            f"(unknown {sorted(keys - set(want))}, missing {sorted(set(want) - keys)})"
        )
    return node


def _convert(prefix: str, kind, node, out: Dict[str, np.ndarray]) -> None:
    node = _leaves(prefix, node, kind)
    if kind is _DENSE:
        out[f"{prefix}.weight"] = np.asarray(node["w"]).T
        out[f"{prefix}.bias"] = np.asarray(node["b"])
    else:
        out[f"{prefix}.weight"] = np.asarray(node["scale"])
        out[f"{prefix}.bias"] = np.asarray(node["bias"])


def vit_state_dict_from_jax(params) -> Dict[str, np.ndarray]:
    """JAX ViT pytree -> ``{state-dict name: numpy array}``. Raises
    ``KeyError`` on an unknown or missing key."""
    params = _leaves("params", params, ("patch", "pos", "blocks", "ln_f", "head"))
    out: Dict[str, np.ndarray] = {"pos": np.asarray(params["pos"])}
    for name, kind in _TOP.items():
        _convert(name, kind, params[name], out)
    blocks = params["blocks"]
    if not isinstance(blocks, (list, tuple)):
        raise KeyError(f"params['blocks'] must be a list, got {type(blocks).__name__}")
    for i, blk in enumerate(blocks):
        blk = _leaves(f"blocks[{i}]", blk, tuple(_BLOCK))
        for name, kind in _BLOCK.items():
            _convert(f"blocks.{i}.{name}", kind, blk[name], out)
    return out


def _jax_leaf(sd, prefix: str, kind):
    """The JAX dense or LayerNorm leaf of a state dict's ``prefix``."""
    w, b = np.asarray(sd[f"{prefix}.weight"]), np.asarray(sd[f"{prefix}.bias"])
    return {"w": w.T, "b": b} if kind is _DENSE else {"scale": w, "bias": b}


def _jax_names(depth: int):
    names = {"pos"} | {f"{n}.{leaf}" for n in _TOP for leaf in ("weight", "bias")}
    return names | {f"blocks.{i}.{n}.{leaf}" for i in range(depth) for n in _BLOCK
                    for leaf in ("weight", "bias")}


def vit_state_dict_to_jax(sd: Dict[str, np.ndarray]):
    """``{state-dict name: array}`` -> the JAX ViT pytree of numpy arrays
    (the inverse of :func:`vit_state_dict_from_jax`). Raises ``KeyError``
    on an unknown or missing name."""
    depth = 1 + max((int(n.split(".")[1]) for n in sd
                     if n.startswith("blocks.") and n.split(".")[1].isdigit()), default=-1)
    want = _jax_names(depth)
    if set(sd) != want:
        raise KeyError(
            f"state dict names differ from a depth-{depth} ViT's: unknown "
            f"{sorted(set(sd) - want)}, missing {sorted(want - set(sd))}"
        )

    out = {name: _jax_leaf(sd, name, kind) for name, kind in _TOP.items()}
    out["pos"] = np.asarray(sd["pos"])
    out["blocks"] = [{name: _jax_leaf(sd, f"blocks.{i}.{name}", kind)
                      for name, kind in _BLOCK.items()} for i in range(depth)]
    return out


_MOE_BLOCK = ("ln1", "qkv", "proj", "ln2", "moe")
_EXPERTS = ("router", "w_in", "w_out")


def vit_moe_state_dict_from_jax(params) -> Dict[str, np.ndarray]:
    """JAX ``ViTMoEDef`` pytree -> ``{state-dict name: numpy array}``: the
    router ``[d, E]`` becomes the ``[E, d]`` Linear weight, the expert
    slabs cross as they are. Raises ``KeyError`` on an unknown or missing
    key."""
    params = _leaves("params", params, ("patch", "pos", "blocks", "ln_f", "head"))
    out: Dict[str, np.ndarray] = {"pos": np.asarray(params["pos"])}
    for name, kind in _TOP.items():
        _convert(name, kind, params[name], out)
    blocks = params["blocks"]
    if not isinstance(blocks, (list, tuple)):
        raise KeyError(f"params['blocks'] must be a list, got {type(blocks).__name__}")
    for i, blk in enumerate(blocks):
        blk = _leaves(f"blocks[{i}]", blk, _MOE_BLOCK)
        for name in _MOE_BLOCK[:-1]:
            _convert(f"blocks.{i}.{name}", _BLOCK[name], blk[name], out)
        moe = _leaves(f"blocks[{i}]['moe']", blk["moe"], _EXPERTS)
        out[f"blocks.{i}.moe.router.weight"] = np.asarray(moe["router"]).T
        out[f"blocks.{i}.moe.w_in"] = np.asarray(moe["w_in"])
        out[f"blocks.{i}.moe.w_out"] = np.asarray(moe["w_out"])
    return out


def vit_moe_state_dict_to_jax(sd: Dict[str, np.ndarray]):
    """The inverse of :func:`vit_moe_state_dict_from_jax`."""
    depth = 1 + max((int(n.split(".")[1]) for n in sd
                     if n.startswith("blocks.") and n.split(".")[1].isdigit()), default=-1)
    blocks = [{f"blocks.{i}.moe.router.weight", f"blocks.{i}.moe.w_in",
               f"blocks.{i}.moe.w_out"} | {f"blocks.{i}.{n}.{leaf}" for n in _MOE_BLOCK[:-1]
                                           for leaf in ("weight", "bias")}
              for i in range(depth)]
    want = ({"pos"} | {f"{n}.{leaf}" for n in _TOP for leaf in ("weight", "bias")}
            ).union(*blocks)
    if set(sd) != want:
        raise KeyError(
            f"state dict names differ from a depth-{depth} ViT-MoE's: unknown "
            f"{sorted(set(sd) - want)}, missing {sorted(want - set(sd))}"
        )

    out = {name: _jax_leaf(sd, name, kind) for name, kind in _TOP.items()}
    out["pos"] = np.asarray(sd["pos"])
    out["blocks"] = [
        {**{name: _jax_leaf(sd, f"blocks.{i}.{name}", _BLOCK[name]) for name in _MOE_BLOCK[:-1]},
         "moe": {"router": np.asarray(sd[f"blocks.{i}.moe.router.weight"]).T,
                 "w_in": np.asarray(sd[f"blocks.{i}.moe.w_in"]),
                 "w_out": np.asarray(sd[f"blocks.{i}.moe.w_out"])}}
        for i in range(depth)]
    return out


def vit_pp_state_dict_from_jax(params) -> Dict[str, np.ndarray]:
    """JAX ``ViTPipelineDef`` pytree (every ``params["blocks"]`` leaf
    stacked over the depth, in storage order) -> ``{state-dict name: numpy
    array}`` with storage row ``g`` as ``blocks.{g}``. Raises ``KeyError``
    on an unknown or missing key."""
    params = _leaves("params", params, ("patch", "pos", "blocks", "ln_f", "head"))
    out: Dict[str, np.ndarray] = {"pos": np.asarray(params["pos"])}
    for name, kind in _TOP.items():
        _convert(name, kind, params[name], out)
    blocks = _leaves("params['blocks']", params["blocks"], tuple(_BLOCK))
    for name, kind in _BLOCK.items():
        node = {k: np.asarray(v) for k, v in
                _leaves(f"params['blocks'][{name!r}]", blocks[name], kind).items()}
        for g in range(node[kind[0]].shape[0]):
            _convert(f"blocks.{g}.{name}", kind, {k: v[g] for k, v in node.items()}, out)
    return out


def vit_pp_state_dict_to_jax(sd: Dict[str, np.ndarray]):
    """The inverse of :func:`vit_pp_state_dict_from_jax`: the blocks'
    leaves stacked in row order."""
    tree = vit_state_dict_to_jax(sd)
    rows = tree.pop("blocks")
    tree["blocks"] = {name: {leaf: np.stack([r[name][leaf] for r in rows]) for leaf in kind}
                      for name, kind in _BLOCK.items()}
    return tree


# -- sharded models: TP shards and EP slabs <-> the full JAX layout -----------


def shard_state_dict(sd: Dict[str, np.ndarray], specs: dict, axis_size: int,
                     index: int) -> Dict[str, np.ndarray]:
    """One rank's shard of a full ``{state-dict name: array}`` (torch
    layout: what :func:`vit_state_dict_from_jax` gives of JAX's full
    parameters, or of an optimizer state that mirrors them): every name of
    ``specs`` (``{name: (axis, dim)}``, a model's ``param_specs()``) cut to
    its ``index``-th of ``axis_size`` blocks along ``dim``, the rest as it
    is."""
    out = dict(sd)
    for name, (_, dim) in specs.items():
        try:
            out[name] = np.array(tensor.shard(np.asarray(sd[name]), dim, axis_size, index))
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    return out


def _sharding(module) -> tuple:
    """``(axis group, {name: (axis, dim)})`` of the leaves a module cuts
    along a dimension (TP shards, EP slabs), else ``(None, {})``."""
    axis = module.tp if isinstance(module, ViTPipeline) else getattr(module, "shard_axis", None)
    return (axis, module.param_specs()) if axis is not None else (None, {})


def _block_row(name: str) -> tuple:
    """``"blocks.{i}.rest"`` -> ``(i, "rest")``; ``(None, name)`` for any
    other name."""
    head, _, rest = name.partition(".")
    if head != "blocks":
        return None, name
    i, _, leaf = rest.partition(".")
    return int(i), leaf


def _stage_rows(module) -> Optional[tuple]:
    """``(first storage row, rows a stage)`` of a pipelined module, else
    None."""
    if not isinstance(module, ViTPipeline) or module.pipe is None:
        return None
    per = module.depth // module.pipe.size
    return module.pipe.index * per, per


def _local(module, sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The full ``sd`` cut to this rank's part of ``module``: a stage's
    storage rows (renamed from 0), then its shards."""
    rows = _stage_rows(module)
    if rows is not None:
        lo, per = rows
        out = {}
        for name, arr in sd.items():
            i, leaf = _block_row(name)
            if i is None:
                out[name] = arr
            elif lo <= i < lo + per:
                out[f"blocks.{i - lo}.{leaf}"] = arr
        sd = out
    axis, specs = _sharding(module)
    if axis is None:
        return sd
    return shard_state_dict(sd, {n: v for n, v in specs.items() if n in sd}, axis.size,
                            axis.index)


def _gather_stages(module, named: Dict[str, torch.Tensor],
                   dst: Optional[int]) -> Optional[Dict[str, torch.Tensor]]:
    """:func:`gather_shards` of a pipelined module: every block leaf
    gathered over the stage group (stage-major, the model index fastest),
    each stage's shards joined along their dimension and its rows renamed
    to their storage rows; the replicated leaves as they are."""
    stage, pp = module.stage, module.pipe.size
    tp = module.tp.size if module.tp is not None else 1
    if dst is not None and dst not in {collectives.global_rank(stage.group, i)
                                       for i in range(stage.size)}:
        return None
    mine = dst is None or collectives.rank() == dst
    specs, per = module.param_specs(), len(module.blocks)
    out = {}
    for name, t in named.items():
        i, leaf = _block_row(name)
        if i is None:
            out[name] = t
            continue
        t = t.detach()[None]
        parts = (collectives.all_gather(t, group=stage.group) if dst is None
                 else collectives.gather(t, dst, group=stage.group))
        if not mine:
            continue
        parts = parts.reshape(pp, tp, *t.shape[1:])
        for p in range(pp):
            out[f"blocks.{p * per + i}.{leaf}"] = (
                torch.cat(list(parts[p]), dim=specs[name][1]) if name in specs else parts[p, 0])
    return out if mine else None


def gather_shards(module, named: Dict[str, torch.Tensor],
                  dst: Optional[int] = None) -> Optional[Dict[str, torch.Tensor]]:
    """``named`` (parameter names -> this rank's tensors) with every sharded
    name gathered over the module's group along its dimension: the full
    tensors, on every rank of the group (every rank must call this). With
    ``dst`` (a rank of the default group) only ``dst`` receives them and
    returns the dict; the other members of its group send their shards,
    the ranks of the other groups send nothing, and all return None. A
    pipelined module's stages are gathered into the full depth
    (:func:`_gather_stages`)."""
    if _stage_rows(module) is not None:
        return _gather_stages(module, named, dst)
    axis, specs = _sharding(module)
    if axis is None:
        return named if dst is None or collectives.rank() == dst else None
    if dst is not None and dst not in {collectives.global_rank(axis.group, i)
                                       for i in range(axis.size)}:
        return None
    out = dict(named)
    for name, (_, dim) in specs.items():
        if name in named:
            t = named[name].detach()
            out[name] = (collectives.all_gather(t, group=axis.group, axis=dim) if dst is None
                         else collectives.gather(t, dst, group=axis.group, axis=dim))
    return out if dst is None or collectives.rank() == dst else None


def full_shapes(module) -> Dict[str, tuple]:
    """Each state-dict entry's shape at full width (a shard's times the
    group's size along its dimension), a pipelined module's rows at every
    storage row."""
    axis, specs = _sharding(module)
    rows = _stage_rows(module)
    out = {}
    for name, t in module.state_dict().items():
        shape = list(t.shape)
        if name in specs:
            shape[specs[name][1]] *= axis.size
        i, leaf = _block_row(name)
        if rows is None or i is None:
            out[name] = tuple(shape)
            continue
        for p in range(module.pipe.size):
            out[f"blocks.{p * rows[1] + i}.{leaf}"] = tuple(shape)
    return out


def state_dict_to_jax(module, sd: Dict[str, np.ndarray]) -> tuple:
    """``(params, bn_state)`` JAX pytrees of a state dict of ``module``'s
    kind."""
    if isinstance(module, ResNet):
        return resnet_state_dict_to_jax(sd)
    if isinstance(module, ViTMoE):
        return vit_moe_state_dict_to_jax(sd), {}
    if isinstance(module, ViTPipeline):
        return vit_pp_state_dict_to_jax(sd), {}
    if isinstance(module, ViT):
        return vit_state_dict_to_jax(sd), {}
    if _is_audit_mlp(module):
        return audit_mlp_state_dict_to_jax(sd), {}
    raise TypeError(f"no JAX layout for a {type(module).__name__}: a ResNet, a ViT, a ViT-MoE "
                    "or a pipelined ViT")


def _from_jax_fn(module):
    """The ``params -> state dict`` converter of ``module``'s kind."""
    if isinstance(module, ResNet):
        return resnet_state_dict_from_jax
    if isinstance(module, ViTMoE):
        return vit_moe_state_dict_from_jax
    if isinstance(module, ViTPipeline):
        return vit_pp_state_dict_from_jax
    if isinstance(module, ViT):
        return vit_state_dict_from_jax
    if _is_audit_mlp(module):
        return audit_mlp_state_dict_from_jax
    raise TypeError(f"no JAX layout for a {type(module).__name__}: a ResNet, a ViT, a ViT-MoE "
                    "or a pipelined ViT")


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy: an f32 CPU tensor's ``.numpy()`` would share its memory, and
    the converted pytree would follow the live weights as they train (a
    device tensor's ``.cpu()`` is a copy already)."""
    host = t.detach().float().cpu()
    return host.numpy().copy() if t.device.type == "cpu" else host.numpy()


def vit_params_to_jax(module: torch.nn.Module):
    """The module's weights as a JAX-layout ViT (or ViT-MoE) pytree of numpy
    f32 arrays, at full width: a sharded module's shards are gathered over
    its group, so every rank of the group must call this then."""
    full = gather_shards(module, dict(module.state_dict()))
    return state_dict_to_jax(module, {n: _numpy(t) for n, t in full.items()})[0]


def sgd_state_to_jax(module: torch.nn.Module, opt_state) -> dict:
    """SGD momentum buffers (one per parameter, in parameter order) as the
    JAX momentum pytree, which mirrors the parameter pytree."""
    names = [n for n, _ in module.named_parameters()]
    if len(opt_state) != len(names):
        raise KeyError(f"{len(opt_state)} momentum buffers for {len(names)} parameters")
    return vit_state_dict_to_jax({n: _numpy(b) for n, b in zip(names, opt_state)})


def _in_param_order(module: torch.nn.Module, sd: Dict[str, np.ndarray]) -> list:
    """``{parameter name: array}`` -> tensors in parameter order, on each
    parameter's device and in its dtype."""
    named = dict(module.named_parameters())
    unknown, missing = sorted(set(sd) - set(named)), sorted(set(named) - set(sd))
    if unknown or missing:
        raise KeyError(f"momentum mismatch: unknown {unknown}, missing {missing}")
    out = []
    for name, p in named.items():
        arr = np.array(sd[name], dtype=np.float32)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {tuple(arr.shape)} vs port shape {tuple(p.shape)}")
        out.append(torch.as_tensor(arr).to(device=p.device, dtype=p.dtype))
    return out


def _checked_pairs(own: Dict[str, torch.Tensor], sd: Dict[str, np.ndarray],
                   what: str = "state dict") -> list:
    """``[(live tensor, array)]`` for every name of ``own``. Raises on any
    unknown, missing or misshapen entry, before anything is copied."""
    unknown = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    if unknown or missing:
        raise KeyError(f"{what} mismatch: unknown {unknown}, missing {missing}")
    for name, arr in sd.items():
        if tuple(np.shape(arr)) != tuple(own[name].shape):
            raise ValueError(
                f"{name}: JAX shape {tuple(np.shape(arr))} vs port shape "
                f"{tuple(own[name].shape)}"
            )
    return [(own[name], sd[name]) for name in own]


def _copy_pairs(pairs) -> None:
    """Copy each array into its live tensor in place (on its device, in its
    dtype): the tensors keep their storage. A transposed view (a JAX
    layout read back) crosses to the device as it lies in memory and is
    permuted there, not by a strided copy on the host."""
    with torch.no_grad():
        for dst, arr in pairs:
            arr = np.asarray(arr, dtype=np.float32)
            if not arr.flags.writeable:  # torch wraps only writable memory
                arr = arr.copy(order="K")  # keeps the layout: no strided gather
            dst.copy_(torch.from_numpy(arr).to(dst.device))


def _load(module: torch.nn.Module, sd: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Copy ``{state-dict name: array}`` (full width) into ``module`` in
    place (on its device, in its dtype; a sharded module takes its
    shards). Raises on any unknown, missing or misshapen entry."""
    _copy_pairs(_checked_pairs(module.state_dict(), _local(module, sd)))
    return module


def sgd_state_from_jax(module: torch.nn.Module, momentum) -> list:
    """A JAX SGD momentum pytree of a ViT -> buffers in parameter order, on
    each parameter's device and in its dtype. Raises on any unknown,
    missing or misshapen entry."""
    return _in_param_order(module, vit_state_dict_from_jax(momentum))


def load_jax_vit(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a JAX ViT (or ViT-MoE) pytree into ``module`` in place (on its
    device, in its dtype; a tensor- or expert-parallel module takes this
    rank's shards of the full arrays). Raises on any unknown, missing or
    misshapen entry."""
    return _load(module, _from_jax_fn(module)(params))


# -- the analysis layer's proxy MLP ---------------------------------------------


def _is_audit_mlp(module) -> bool:
    from tpu_dist_torch.analysis.step_audit import _AuditMLP  # noqa: PLC0415

    return isinstance(module, _AuditMLP)


def audit_mlp_state_dict_from_jax(params) -> Dict[str, np.ndarray]:
    """The JAX analysis proxy's MLP (``{"w1": [12, 16], "b1", "w2": [16,
    16], "b2"}``, ``tpu_dist/analysis/jaxpr_audit.py::_AuditMLP``) as the
    port's state dict (``analysis/step_audit.py::_AuditMLP``: ``fc1`` and
    ``fc2`` in the Linear layout)."""
    return {"fc1.weight": np.asarray(params["w1"]).T, "fc1.bias": np.asarray(params["b1"]),
            "fc2.weight": np.asarray(params["w2"]).T, "fc2.bias": np.asarray(params["b2"])}


def audit_mlp_state_dict_to_jax(sd: Dict[str, np.ndarray]) -> dict:
    """:func:`audit_mlp_state_dict_from_jax` the other way."""
    return {"w1": np.asarray(sd["fc1.weight"]).T, "b1": np.asarray(sd["fc1.bias"]),
            "w2": np.asarray(sd["fc2.weight"]).T, "b2": np.asarray(sd["fc2.bias"])}


def load_jax_audit_mlp(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy JAX's proxy MLP weights (``jaxpr_audit._AuditMLP().init(
    PRNGKey(0))``'s, as numpy) into the port's in place. Raises on any
    unknown, missing or misshapen entry."""
    return _load(module, audit_mlp_state_dict_from_jax(params))


def numpy_vit_params(model, seed: int = 0):
    """A JAX-layout ViT pytree of numpy f32 arrays drawn from
    ``np.random.default_rng(seed)``, in ``ViTDef.init``'s distributions
    (normal / sqrt(fan_in) kernels, zero biases, unit LayerNorm scales,
    normal * 0.02 positions). ``model`` supplies the widths (a
    :class:`~tpu_dist_torch.nn.vit.ViT` or anything with its fields)."""
    rng = np.random.default_rng(seed)

    def dense(din, dout):
        w = rng.standard_normal((din, dout), dtype=np.float32) * np.float32(din ** -0.5)
        return {"w": w, "b": np.zeros((dout,), np.float32)}

    def ln(dim):
        return {"scale": np.ones((dim,), np.float32), "bias": np.zeros((dim,), np.float32)}

    dim, hidden = model.dim, model.mlp_ratio * model.dim
    n_patches = (model.image_size // model.patch_size) ** 2
    return {
        "patch": dense(model.patch_size * model.patch_size * 3, dim),
        "pos": rng.standard_normal((n_patches, dim), dtype=np.float32) * np.float32(0.02),
        "blocks": [
            {"ln1": ln(dim), "qkv": dense(dim, 3 * dim), "proj": dense(dim, dim),
             "ln2": ln(dim), "mlp1": dense(dim, hidden), "mlp2": dense(hidden, dim)}
            for _ in range(model.depth)
        ],
        "ln_f": ln(dim),
        "head": dense(dim, model.num_classes),
    }


# -- ResNet ------------------------------------------------------------------

_BN_P = ("scale", "bias")
_BN_S = ("mean", "var")
_BLOCK_UNITS = ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3", "sc_conv", "sc_bn")
_STAGES = tuple(f"stage{i}" for i in range(1, 5))


def _units(where: str, node, state) -> None:
    """Check one block's (or the stem's) parameter and state dicts: conv
    and bn units of known names, each BN in both."""
    if not isinstance(node, dict) or not set(node) <= set(_BLOCK_UNITS):
        raise KeyError(f"{where}: unknown units {sorted(set(node) - set(_BLOCK_UNITS))}")
    bns = {k for k in node if k.startswith(("bn", "sc_bn"))}
    if state is not None and set(state) != bns:
        raise KeyError(f"{where}: BN params {sorted(bns)} vs BN state {sorted(state)}")


def resnet_state_dict_from_jax(params, bn_state=None) -> Dict[str, np.ndarray]:
    """JAX ResNet ``(params, bn_state)`` pytrees -> ``{state-dict name:
    numpy array}``. With ``bn_state=None`` only parameters are converted
    (a momentum pytree, which mirrors them). Raises ``KeyError`` on an
    unknown or missing key."""
    params = _leaves("params", params, ("stem_conv", "stem_bn", *_STAGES, "fc"))
    if bn_state is not None:
        bn_state = _leaves("bn_state", bn_state, ("stem_bn", *_STAGES))
    out: Dict[str, np.ndarray] = {}

    def unit(prefix, name, node, state):
        if "conv" in name:
            w = np.asarray(_leaves(f"{prefix}{name}", node, ("w",))["w"])
            out[f"{prefix}{name}.weight"] = w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            return
        node = _leaves(f"{prefix}{name}", node, _BN_P)
        out[f"{prefix}{name}.weight"] = np.asarray(node["scale"])
        out[f"{prefix}{name}.bias"] = np.asarray(node["bias"])
        if state is not None:
            st = _leaves(f"{prefix}{name} state", state, _BN_S)
            out[f"{prefix}{name}.running_mean"] = np.asarray(st["mean"])
            out[f"{prefix}{name}.running_var"] = np.asarray(st["var"])

    unit("", "stem_conv", params["stem_conv"], None)
    unit("", "stem_bn", params["stem_bn"], None if bn_state is None else bn_state["stem_bn"])
    for stage in _STAGES:
        blocks = params[stage]
        states = None if bn_state is None else bn_state[stage]
        if not isinstance(blocks, (list, tuple)) or (
                states is not None and len(states) != len(blocks)):
            raise KeyError(f"{stage}: expected a list of blocks (and one state per block)")
        for i, blk in enumerate(blocks):
            st = None if states is None else states[i]
            _units(f"{stage}[{i}]", blk, st)
            for name, node in blk.items():
                unit(f"{stage}.{i}.", name, node, None if st is None else st.get(name))
    fc = _leaves("fc", params["fc"], _DENSE)
    out["fc.weight"] = np.asarray(fc["w"]).T
    out["fc.bias"] = np.asarray(fc["b"])
    return out


def resnet_state_dict_to_jax(sd: Dict[str, np.ndarray]):
    """``{state-dict name: array}`` -> JAX ``(params, bn_state)`` pytrees of
    numpy arrays (the inverse of :func:`resnet_state_dict_from_jax`);
    ``bn_state`` is None when ``sd`` holds no running statistics. Raises
    ``KeyError`` on an unknown name."""
    params: dict = {stage: [] for stage in _STAGES}
    state: dict = {stage: [] for stage in _STAGES}
    with_state = any(n.endswith(".running_mean") for n in sd)

    def slot(tree, parts):
        if parts[0] in _STAGES:
            blocks, i = tree[parts[0]], int(parts[1])
            while len(blocks) <= i:
                blocks.append({})
            return blocks[i], parts[2]
        return tree, parts[0]

    for name, arr in sd.items():
        parts = name.split(".")
        leaf, arr = parts[-1], np.asarray(arr)
        if parts[0] == "fc" and leaf in ("weight", "bias"):
            params.setdefault("fc", {})["w" if leaf == "weight" else "b"] = (
                arr.T if leaf == "weight" else arr)
            continue
        node, unit = slot(params, parts[:-1])
        if "conv" in unit and leaf == "weight":
            node[unit] = {"w": arr.transpose(2, 3, 1, 0)}  # OIHW -> HWIO
        elif "bn" in unit and leaf in ("weight", "bias"):
            node.setdefault(unit, {})["scale" if leaf == "weight" else "bias"] = arr
        elif "bn" in unit and leaf in ("running_mean", "running_var"):
            snode, _ = slot(state, parts[:-1])
            snode.setdefault(unit, {})["mean" if leaf == "running_mean" else "var"] = arr
        else:
            raise KeyError(f"unknown ResNet state dict name {name!r}")
    # round-trip check: every key the forward direction expects is there
    resnet_state_dict_from_jax(params, state if with_state else None)
    return params, (state if with_state else None)


def load_jax_resnet(module: torch.nn.Module, params, bn_state) -> torch.nn.Module:
    """Copy JAX ResNet ``(params, bn_state)`` into ``module`` in place (on
    its device, in its dtype). Raises on any unknown, missing or misshapen
    entry."""
    return _load(module, resnet_state_dict_from_jax(params, bn_state))


def resnet_params_to_jax(module: torch.nn.Module):
    """The module's weights and running statistics as JAX-layout
    ``(params, bn_state)`` pytrees of numpy f32 arrays."""
    return resnet_state_dict_to_jax({n: _numpy(t) for n, t in module.state_dict().items()})


def resnet_sgd_state_from_jax(module: torch.nn.Module, momentum) -> list:
    """A JAX SGD momentum pytree of a ResNet -> buffers in parameter order."""
    return _in_param_order(module, resnet_state_dict_from_jax(momentum))


def resnet_sgd_state_to_jax(module: torch.nn.Module, opt_state) -> dict:
    """SGD momentum buffers (parameter order) as the JAX ResNet momentum
    pytree."""
    names = [n for n, _ in module.named_parameters()]
    if len(opt_state) != len(names):
        raise KeyError(f"{len(opt_state)} momentum buffers for {len(names)} parameters")
    return resnet_state_dict_to_jax({n: _numpy(b) for n, b in zip(names, opt_state)})[0]


def load_jax_params(module: torch.nn.Module, params, bn_state=None) -> torch.nn.Module:
    """Copy JAX ``(params, bn_state)`` pytrees into a ResNet or a ViT in
    place (a ViT has no BN state: ``bn_state`` must be empty)."""
    if isinstance(module, ResNet):
        return load_jax_resnet(module, params, bn_state)
    if isinstance(module, (ViT, ViTMoE, ViTPipeline)):
        if bn_state:
            raise KeyError(f"a ViT has no BN state; got {sorted(bn_state)}")
        return load_jax_vit(module, params)
    raise TypeError(f"no JAX layout for a {type(module).__name__}: a ResNet, a ViT or a ViT-MoE")


def jax_layout_template(module: torch.nn.Module, local: bool = False):
    """``(params, bn_state)`` pytrees of ``module`` in JAX layout whose
    leaves are zero-stride f32 numpy views: every leaf's shape and dtype,
    and no copy of the weights (a restore template). The shapes are the
    full width of a sharded module's leaves (the checkpoint's layout), or
    with ``local`` this rank's shards."""
    shapes = ({n: tuple(t.shape) for n, t in module.state_dict().items()} if local
              else full_shapes(module))
    return state_dict_to_jax(module, {n: np.broadcast_to(np.float32(0), s)
                               for n, s in shapes.items()})


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """Where one state-dict entry of a module lies in the JAX pytree: its
    ``section`` (``"params"`` or ``"bn_state"``), the ``key`` (keystr path)
    of its leaf there, the permutation ``perm`` (JAX dimension ``j`` holds
    torch dimension ``perm[j]``) and, for a stacked leaf (a pipelined ViT's
    blocks), the ``row`` of the stack it is (the module's local row);
    None otherwise."""

    section: str
    key: str
    perm: tuple
    row: Optional[int] = None


def _perm_of(jax_arr: np.ndarray, shape: tuple) -> tuple:
    """The permutation that lays an index array of torch ``shape`` out as
    ``jax_arr`` (its JAX layout): JAX dimension ``j`` steps by the C stride
    of torch dimension ``perm[j]``; dimensions of size 1 take the unused
    ones in order."""
    strides = [int(np.prod(shape[d + 1:])) for d in range(len(shape))]
    perm, used = [None] * jax_arr.ndim, set()
    base = int(jax_arr.reshape(-1)[0]) if jax_arr.size else 0
    for j, size in enumerate(jax_arr.shape):
        if size < 2:
            continue
        idx = [0] * jax_arr.ndim
        idx[j] = 1
        step = int(jax_arr[tuple(idx)]) - base
        d = next(d for d in range(len(shape))
                 if d not in used and strides[d] == step and shape[d] == size)
        perm[j] = d
        used.add(d)
    rest = iter(d for d in range(len(shape)) if d not in used)
    return tuple(p if p is not None else next(rest) for p in perm)


_LAYOUTS: dict = {}


def leaf_layout(module: torch.nn.Module) -> Dict[str, LeafLayout]:
    """``{state-dict name: LeafLayout}`` of every parameter and buffer of
    ``module`` (a ResNet, a ViT, a ViT-MoE or a pipelined ViT), found by
    sending small index arrays through the converters (each dimension cut
    to at most 2, which keeps every C stride distinct): the value of each
    element names its entry and its position. Cached by the names and
    shapes."""
    full = tuple((n, tuple(t.shape)) for n, t in module.state_dict().items())
    cache_key = (type(module).__name__, full)
    if cache_key in _LAYOUTS:
        return _LAYOUTS[cache_key]
    shapes = tuple((n, tuple(min(int(d), 2) for d in s)) for n, s in full)
    sd, starts, off = {}, [], 0
    for name, shape in shapes:
        k = int(np.prod(shape))
        sd[name] = np.arange(off, off + k, dtype=np.int64).reshape(shape)
        starts.append((off, name))
        off += k
    lo = [s for s, _ in starts]
    params, bn = state_dict_to_jax(module, sd)
    stacked = isinstance(module, ViTPipeline)
    out = {}
    for section, tree in (("params", params), ("bn_state", bn or {})):
        for key, arr in keystr_leaves(tree).items():
            arr = np.asarray(arr)
            rows = list(arr) if stacked and key.startswith("['blocks']") else [arr]
            for r, a in enumerate(rows):
                name = starts[int(np.searchsorted(lo, int(a.reshape(-1)[0]), "right")) - 1][1]
                out[name] = LeafLayout(section, key, _perm_of(a, dict(shapes)[name]),
                                       r if len(rows) > 1 or a is not arr else None)
    _LAYOUTS[cache_key] = out
    return out


def jax_model_specs(model: torch.nn.Module) -> dict:
    """The model's TP/EP specs in JAX layout, ``{params keystr: spec}``: the
    model axis name at the JAX dimension its ``param_specs`` shards (a
    tuple of one entry a dimension), None for a replicated leaf; what
    ``compose_fsdp_specs`` takes as ``model_specs``."""
    layout, specs = leaf_layout(model), model.param_specs()
    out = {lay.key: None for lay in layout.values() if lay.section == "params"}
    for name, (axis, dim) in specs.items():
        lay = layout[name]
        entries = [None] * len(lay.perm)
        entries[lay.perm.index(dim)] = axis
        out[lay.key] = tuple(entries)
    return out


# -- TrainState <-> the flat JAX-keyed dict of a checkpoint --------------------

_KEY_PART = re.compile(r"\[(?:'([^'\\]*)'|(\d+))\]")


def keystr_leaves(tree, prefix: str = "") -> dict:
    """The leaves of a pytree of dicts, lists/tuples and leaves as
    ``{jax.tree_util.keystr(path): leaf}``, in JAX's flattening order (dict
    keys sorted, sequences by index), each leaf as it is. An empty dict or
    tuple has no leaves."""
    if isinstance(tree, dict):
        out: dict = {}
        for key in sorted(tree):
            out.update(keystr_leaves(tree[key], f"{prefix}[{key!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, node in enumerate(tree):
            out.update(keystr_leaves(node, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def keystr_flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """:func:`keystr_leaves` with every leaf a C-contiguous numpy array."""
    out = {}
    for key, leaf in keystr_leaves(tree, prefix).items():
        arr = np.asarray(leaf)
        out[key] = arr if arr.flags.c_contiguous else np.array(arr, order="C")
    return out


def _parse_keystr(key: str) -> list:
    parts = [m.group(1) if m.group(2) is None else int(m.group(2))
             for m in _KEY_PART.finditer(key)]
    if "".join(m.group(0) for m in _KEY_PART.finditer(key)) != key or not parts:
        raise KeyError(f"not a keystr path of dict keys and list indices: {key!r}")
    return parts


def _as_lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _as_lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise KeyError(f"list indices {sorted(out)} are not 0..{len(out) - 1}")
        return [out[i] for i in range(len(out))]
    return out


def keystr_unflatten(flat: Dict[str, np.ndarray]) -> dict:
    """The inverse of :func:`keystr_flatten`: nested dicts and lists."""
    root: dict = {}
    for key, arr in flat.items():
        parts = _parse_keystr(key)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise KeyError(f"{key!r} nests under a leaf")
        node[parts[-1]] = arr
    return _as_lists(root)


def _host_in_jax_order(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` in the port's shape whose memory already holds
    the JAX layout: a 4-D conv weight lies as HWIO, a 2-D weight as its
    transpose. The converters' transposes then give C-contiguous JAX
    arrays with no strided copy on the host; the permutation runs on
    ``t``'s device. Always a copy, never a view of the live tensor."""
    t = t.detach().float()
    if t.dim() == 4:  # OIHW -> HWIO in memory
        return t.permute(2, 3, 1, 0).clone(
            memory_format=torch.contiguous_format).cpu().numpy().transpose(3, 2, 0, 1)
    if t.dim() == 2:  # [out, in] -> [in, out] in memory
        return t.t().clone(memory_format=torch.contiguous_format).cpu().numpy().T
    return _numpy(t)


def _param_tree(model, buffers, what: str, dst: Optional[int] = None):
    """Per-parameter buffers (parameter order) as a JAX pytree mirroring
    the parameters: host copies in the JAX layout, at full width (a sharded
    model's are gathered over its group: with ``dst``, to that rank alone,
    and the other ranks return None)."""
    names = [n for n, _ in model.named_parameters()]
    if len(buffers) != len(names):
        raise KeyError(f"{len(buffers)} {what} buffers for {len(names)} parameters")
    full = gather_shards(model, dict(zip(names, buffers)), dst)
    if full is None:
        return None
    return state_dict_to_jax(model, {n: _host_in_jax_order(b) for n, b in full.items()})[0]


def _is_adam(opt_state) -> bool:
    """AdamW's and LAMB's state: ``{"mu": [...], "nu": [...], "count"}``
    (``mu`` and ``nu`` flat tensors under ZeRO-1)."""
    if not isinstance(opt_state, dict):
        return False
    if set(opt_state) != {"mu", "nu", "count"}:
        raise KeyError(f"optimizer state keys {sorted(opt_state)}: expected count, mu, nu")
    return True


_ORDERS: dict = {}


def jax_ravel_order(model: torch.nn.Module) -> np.ndarray:
    """``order[j]``: the index, in the port's flat parameter vector (the
    parameters in order, each raveled in its torch layout), of element
    ``j`` of JAX's ``ravel_pytree(params)`` (the sorted leaves, each in
    its JAX layout). Cached by the parameters' names and shapes."""
    shapes = tuple((n, tuple(p.shape)) for n, p in model.named_parameters())
    key = (type(model).__name__, shapes)
    if key not in _ORDERS:
        sd, off = {}, 0
        for name, shape in shapes:
            k = int(np.prod(shape))
            sd[name] = np.arange(off, off + k, dtype=np.int64).reshape(shape)
            off += k
        tree = state_dict_to_jax(model, sd)[0]
        _ORDERS[key] = np.concatenate([np.asarray(a).reshape(-1)
                                       for a in keystr_leaves(tree).values()])
    return _ORDERS[key]


def _flat_parts(state) -> dict:
    """The flat parts of ``state`` that each rank holds a piece of, by
    checkpoint key: ``(tensor, "shard" | "row")``."""
    if state.layout is None:
        return {}
    parts = {}
    opt = state.opt_state
    if isinstance(opt, torch.Tensor):
        parts["['opt_state']"] = (opt, "shard")
    elif isinstance(opt, dict) and isinstance(opt.get("mu"), torch.Tensor):
        parts["['opt_state']['mu']"] = (opt["mu"], "shard")
        parts["['opt_state']['nu']"] = (opt["nu"], "shard")
    for k, v in (state.ef or {}).items():
        parts[f"['ef'][{k!r}]"] = (v, "row" if k == "r1" else "shard")
    return parts


def _to_jax_order(vec: np.ndarray, order: np.ndarray) -> np.ndarray:
    out = np.zeros_like(vec)
    out[:len(order)] = vec[order]
    return out


def _from_jax_order(vec: np.ndarray, order: np.ndarray) -> np.ndarray:
    out = np.zeros_like(vec)
    out[order] = vec[:len(order)]
    return out


def _gathered_flat_parts(state, dst: Optional[int] = None) -> Optional[Dict[str, np.ndarray]]:
    """The flat parts as the JAX package's global arrays, in its ravel
    order. Gathers over the layout's group (the data axis under ``--sp``,
    else every rank): every rank must call it. With ``dst``, only rank
    ``dst`` receives the vectors and returns them; the other members of its
    group send their parts, the ranks of the other groups (the other seq
    indices, whose parts are the same) send nothing, and all return None.
    Without ``dst`` each group gathers its own copy."""
    parts = _flat_parts(state)
    group = state.layout.group if parts else None
    if dst is not None and not collectives.holds(group, dst):
        return None
    mine = dst is None or collectives.rank() == dst
    out = {}
    for key, (t, kind) in parts.items():
        x = t.detach().float()
        full = (collectives.all_gather_flat(x, group=group, kind="ckpt") if dst is None
                else collectives.gather_flat(x, dst, group=group, kind="ckpt"))
        if not mine:
            continue
        full, order = full.cpu().numpy(), jax_ravel_order(state.params)
        if kind == "row":
            out[key] = np.concatenate([_to_jax_order(r, order)
                                       for r in full.reshape(state.layout.world, -1)])
        else:
            out[key] = _to_jax_order(full, order)
    return out if mine else None


def train_state_to_flat(state, dst: Optional[int] = None) -> Optional[Dict[str, np.ndarray]]:
    """A port ``TrainState`` (a ResNet's, a ViT's or a ViT-MoE's) as the
    ``{keystr: array}`` dict of a JAX ``TrainState``: HWIO conv kernels, ``mean``/
    ``var`` BN statistics, the optimizer state, ``step`` as an int32
    scalar and the ``ef`` residuals; the ViT's ``bn_state`` is ``{}``, as
    ``ef`` is without int8_ef, so neither has an entry. The optimizer
    state is the momentum pytree mirroring the parameters (SGD, LARS);
    AdamW's and LAMB's ``{"mu", "nu", "count"}`` as the JAX dict
    (``['opt_state']['mu']...``, ``['opt_state']['count']`` int32); or,
    with a ``layout``, the ZeRO-1 flat state gathered into the JAX global
    vectors (every rank must call this then). With ``dst`` only rank
    ``dst`` builds the dict; the others send their flat parts, if any,
    and return None. One 1-D tensor without a
    layout is written as it is, as the single entry ``['opt_state']`` (a
    global flat momentum already in the JAX order). A tensor- or
    expert-parallel model's shards, and their optimizer state, are
    gathered into JAX's full layout over its group (every rank must call
    this then; with ``dst``, to that rank alone), as the JAX ``save``
    gathers its sharded leaves to process 0. Host
    copies: the dict does not follow the live tensors. Under FSDP the
    shards are all-gathered first (every rank must call this then)."""
    if state.fsdp is not None:
        fs = state.fsdp
        with fs.gathered():
            return train_state_to_flat(dataclasses.replace(
                state, fsdp=None, opt_state=_fsdp_opt(state, fs.full_leaves)), dst)
    model = state.params
    _from_jax_fn(model)  # a TypeError for a model with no JAX layout
    flat_parts = _gathered_flat_parts(state, dst)
    if flat_parts is None and getattr(model, "shard_axis", None) is None:
        return None
    # a sharded model's leaves and their optimizer state are gathered over
    # its group (before any rank leaves): with dst, to that rank alone
    opt, opt_tree = state.opt_state, None
    if isinstance(opt, torch.Tensor):
        pass
    elif _is_adam(opt):
        if not isinstance(opt["mu"], torch.Tensor):
            opt_tree = {"mu": _param_tree(model, opt["mu"], "mu", dst),
                        "nu": _param_tree(model, opt["nu"], "nu", dst)}
    else:
        opt_tree = _param_tree(model, opt, "momentum", dst)
    full = gather_shards(model, dict(model.state_dict()), dst)
    if flat_parts is None or full is None:
        return None
    params, bn_state = state_dict_to_jax(model, {n: _host_in_jax_order(t) for n, t in full.items()})
    if "['opt_state']" in flat_parts:
        opt_tree = flat_parts["['opt_state']"]
    elif isinstance(opt, torch.Tensor):
        opt_tree = _numpy(opt)
    elif _is_adam(opt):
        if "['opt_state']['mu']" in flat_parts:
            opt_tree = {"mu": flat_parts["['opt_state']['mu']"],
                        "nu": flat_parts["['opt_state']['nu']"]}
        opt_tree["count"] = np.asarray(opt["count"].item(), np.int32)
    ef = {k: flat_parts[f"['ef'][{k!r}]"] for k in (state.ef or {})}
    return keystr_flatten({"params": params, "bn_state": bn_state, "opt_state": opt_tree,
                           "step": np.asarray(state.step, np.int32), "ef": ef})


# -- a rank's pieces of the global JAX-layout leaves (the sharded format) ------


@dataclasses.dataclass
class Window:
    """One window of a global JAX-layout leaf that this rank holds: the
    leaf's ``key``, the window's ``origin`` and ``extent`` in the global
    array, its numpy ``dtype``, whether this rank is the one that writes it
    to a sharded checkpoint (``writer``: JAX's ``replica_id == 0``), and
    ``read()`` (a host copy in JAX layout) and ``write(array)`` (the
    window, in JAX layout, copied into the live tensors). A flat part
    (ZeRO-1's optimizer state, the int8_ef residuals) is the whole global
    vector: its ``read`` is None (the save gathers it) and its ``write``
    takes this rank's part of the vector."""

    key: str
    origin: tuple
    extent: tuple
    dtype: np.dtype
    writer: bool
    read: Optional[object]
    write: object


def _host_jax(t: torch.Tensor, perm: tuple) -> np.ndarray:
    """A host copy of ``t`` laid out in JAX layout (``perm``), permuted on
    ``t``'s device: one device-to-host copy, never a view of ``t``."""
    x = t.detach().permute(*perm).contiguous()
    if x.device.type == "cpu":
        return (x.clone() if x.data_ptr() == t.data_ptr() else x).numpy()
    return x.cpu().numpy()


def _tensor_window(key, origin, extent, writer, tensors, perm, stacked) -> Window:
    inv = tuple(int(i) for i in np.argsort(perm))

    def read():
        arrs = [_host_jax(t, perm) for t in tensors]
        return np.stack(arrs) if stacked else arrs[0]

    def write(arr):
        parts = list(arr) if stacked else [arr]
        with torch.no_grad():
            for t, a in zip(tensors, parts):
                a = np.ascontiguousarray(a, dtype=np.float32)
                t.copy_(torch.from_numpy(a).to(t.device).permute(*inv))

    return Window(key, tuple(origin), tuple(extent), np.dtype(np.float32), writer, read, write)


def _mesh_coords(state) -> dict:
    """This rank's index on each axis of its mesh: ``model`` (TP, EP) and
    ``pipe`` from the model's groups, ``data`` from the FSDP axis, else
    ``state.replicas`` (the ranks that share this rank's model index),
    else the rank itself over the model axes' extent (one data row a
    ``prod(model axes)`` consecutive ranks, as every mesh without a seq
    axis lays them)."""
    model, fs = state.params, state.fsdp
    out = {}
    tp = model.tp if isinstance(model, ViTPipeline) else getattr(model, "shard_axis", None)
    if tp is not None:
        out["model"] = tp.index
    ways = tp.size if tp is not None else 1
    if isinstance(model, ViTPipeline) and model.pipe is not None:
        out["pipe"] = model.pipe.index
        ways *= model.pipe.size
    if fs is not None and fs.axis is not None:
        out["data"] = fs.axis.index
    elif state.replicas is not None:
        out["data"] = state.replicas.index
    else:
        out["data"] = collectives.rank() // ways
    return out


def _param_mirrors(state) -> list:
    """``[(key prefix, buffers)]`` of the optimizer state that mirrors the
    parameters (laid as the parameters, or as ``state.fsdp.entries``):
    ``['opt_state']`` (SGD, LARS) or ``['opt_state']['mu']``/``['nu']``
    (AdamW, LAMB); none for a flat (ZeRO-1) state."""
    opt = state.opt_state
    if isinstance(opt, torch.Tensor):
        return []
    if _is_adam(opt):
        if isinstance(opt["mu"], torch.Tensor):
            return []
        return [("['opt_state']['mu']", opt["mu"]), ("['opt_state']['nu']", opt["nu"])]
    return [("['opt_state']", opt)]


def shard_windows(state) -> tuple:
    """``(windows, shapes)``: the :class:`Window` s of every global
    JAX-layout leaf of ``state`` that this rank holds, and ``{key: global
    shape}`` of every leaf, the counterpart of a JAX ``TrainState``'s
    ``addressable_shards``. Which rank writes what:

    * a replicated leaf and ``['step']``: rank 0 (every coordinate 0);
    * a TP or EP shard: the data rank 0 of each model index (a column
      shard is a row block of ``nn.Linear.weight``); a pipelined model's
      stage: its rows ``blocks.{g}`` in storage order, stacked as JAX
      stacks them, from the data rank 0 of each pipe (and model) index;
    * an FSDP shard: every data rank its own window (each virtual rank of
      a lockstep group, all in this process); a leaf FSDP leaves whole under
      FSDP×TP, the model's shards of it as a TP shard;
    * ZeRO-1's flat optimizer state and the int8_ef residuals: the whole
      JAX-order vector from rank 0 (:func:`shard_pieces` gathers it), where
      JAX writes each device's slice: either assembles in either package's
      ``restore_sharded``.

    The optimizer state that mirrors the parameters has the parameters'
    windows."""
    model, fs = state.params, state.fsdp
    _from_jax_fn(model)
    coords = _mesh_coords(state)
    layout = leaf_layout(model)
    axis, specs = _sharding(model)
    rows = _stage_rows(model)
    depth = model.depth if rows is not None else None
    full = {}
    for gname, shape in full_shapes(model).items():
        i, leaf = _block_row(gname)
        full[gname if rows is None or i is None else f"blocks.{i - rows[0]}.{leaf}"] = shape
    pnames = [n for n, _ in model.named_parameters()]
    pindex = {n: i for i, n in enumerate(pnames)}
    mirrors = _param_mirrors(state)
    shapes, per_key = {}, {}

    def writes(sharded: set) -> bool:
        return all(v == 0 for k, v in coords.items() if k not in sharded)

    def add(key, jax_origin, jax_extent, writer, tensor, perm, row):
        per_key.setdefault(key, []).append((row, jax_origin, jax_extent, writer, tensor, perm))

    for name, t in model.state_dict().items():
        lay = layout[name]
        key = f"['{lay.section}']{lay.key}"
        gshape = tuple(full[name][p] for p in lay.perm)
        if lay.row is not None:
            gshape = (depth,) + gshape
        i = pindex.get(name)
        own = mirrors if i is not None else []
        shapes[key] = gshape
        for prefix, _ in own:
            shapes[prefix + lay.key] = gshape
        sharded, base = set(), [0] * len(lay.perm)  # the origin in torch (full) coordinates
        if name in specs:
            dim = specs[name][1]
            base[dim] = axis.index * t.shape[dim]
            sharded.add("model")
        if lay.row is not None:
            sharded.add("pipe")
        if fs is None or i is None:
            held = [(t, i, None)]  # (live tensor, optimizer entry, held FSDP rank)
        else:
            start = sum(len(s) for s in fs.shards[:i])
            held = [(sh, start + k, k) for k, sh in enumerate(fs.shards[i])]
            if fs.sharded(i):
                sharded.add("data")
        for live, entry, k in held:
            origin, ext = list(base), list(t.shape)
            if "data" in sharded:
                d, lo, size = fs.block(i, k)
                origin[d] += lo
                ext[d] = size
            jo = tuple(origin[p] for p in lay.perm)
            je = tuple(ext[p] for p in lay.perm)
            add(key, jo, je, writes(sharded), live, lay.perm, lay.row)
            for prefix, bufs in own:
                add(prefix + lay.key, jo, je, writes(sharded), bufs[entry], lay.perm, lay.row)

    windows = []
    for key, parts in per_key.items():
        if parts[0][0] is None:  # one window a part
            for _, jo, je, writer, tensor, perm in parts:
                windows.append(_tensor_window(key, jo, je, writer, [tensor], perm, False))
            continue
        # a stage's rows, stacked along JAX's leading (depth) axis
        parts.sort(key=lambda p: p[0])
        _, jo, je, writer, _, perm = parts[0]
        windows.append(_tensor_window(key, (rows[0] + parts[0][0],) + jo, (len(parts),) + je,
                                      writer, [p[4] for p in parts], perm, True))
    rank0 = writes(set())
    opt = state.opt_state
    if isinstance(opt, torch.Tensor) and state.layout is None:
        # a global flat momentum already in the JAX order, whole on every rank
        windows.append(_tensor_window("['opt_state']", (0,), tuple(opt.shape), rank0, [opt],
                                      (0,), False))
        shapes["['opt_state']"] = tuple(opt.shape)
    if _is_adam(opt):
        count = opt["count"]
        windows.append(Window("['opt_state']['count']", (), (), np.dtype(np.int32), rank0,
                              lambda: np.asarray(count.item(), np.int32),
                              lambda a: count.fill_(int(np.asarray(a)))))
        shapes["['opt_state']['count']"] = ()
    for key, (t, kind) in _flat_parts(state).items():
        lay_ = state.layout
        n = lay_.world * lay_.padded if kind == "row" else lay_.padded

        def write(a, key=key, t=t, kind=kind):
            _copy_pairs(_local_flat_pairs(state, {key: (t, kind)}, {key: a}))

        windows.append(Window(key, (0,), (n,), np.dtype(np.float32), rank0, None, write))
        shapes[key] = (n,)
    windows.append(Window("['step']", (), (), np.dtype(np.int32), rank0,
                          lambda: np.asarray(state.step, np.int32), lambda a: None))
    shapes["['step']"] = ()
    return windows, shapes


def shard_pieces(state) -> tuple:
    """``(pieces, shapes)``: ``{(key, origin): host array}`` of the windows
    this rank writes to a sharded checkpoint, and every leaf's global
    shape (:func:`shard_windows`). The flat parts are gathered to rank 0
    over the layout's group (the data axis of seq index 0 under ``--sp``),
    so every rank must call this when the state has any."""
    flat = _gathered_flat_parts(state, dst=0)
    windows, shapes = shard_windows(state)
    pieces = {}
    for w in windows:
        if not w.writer:
            continue
        pieces[(w.key, w.origin)] = flat[w.key] if w.read is None else w.read()
    return pieces, shapes


def _fsdp_opt(state, fn):
    """The optimizer state of an FSDP ``state`` with ``fn`` applied to its
    per-entry lists (``mu``/``nu``, or the momentum); the count as it is."""
    opt = state.opt_state
    if _is_adam(opt):
        return {"mu": fn(opt["mu"]), "nu": fn(opt["nu"]), "count": opt["count"]}
    return fn(opt)


def _zeros_like_leaf(shape, dtype=np.float32) -> np.ndarray:
    return np.broadcast_to(np.zeros((), dtype), tuple(shape))


def restore_template(state) -> Dict[str, np.ndarray]:
    """``{keystr: leaf}`` of ``state`` in the checkpoint's layout, for
    :func:`tpu_dist_torch.ckpt.restore`'s ``template``: every leaf's
    global shape and dtype (the flat parts at this run's extent), as
    zero-stride views (no copy of anything)."""
    model = state.params
    params, bn_state = jax_layout_template(model)
    tree = {"params": params, "bn_state": bn_state or {}}
    opt, lay = state.opt_state, state.layout
    # per-leaf optimizer buffers mirror the parameters' (zero-stride) leaves
    if isinstance(opt, torch.Tensor):
        tree["opt_state"] = _zeros_like_leaf((lay.padded if lay else opt.numel(),))
    elif _is_adam(opt):
        flat = isinstance(opt["mu"], torch.Tensor)
        tree["opt_state"] = {
            "mu": _zeros_like_leaf((lay.padded,)) if flat else params,
            "nu": _zeros_like_leaf((lay.padded,)) if flat else params,
            "count": _zeros_like_leaf((), np.int32)}
    else:
        tree["opt_state"] = params
    tree["step"] = _zeros_like_leaf((), np.int32)
    if state.ef:
        tree["ef"] = {k: _zeros_like_leaf((lay.world * lay.padded,) if k == "r1"
                                          else (lay.padded,)) for k in state.ef}
    return keystr_leaves(tree)


def load_train_state(state, flat: Dict[str, np.ndarray]):
    """Copy a checkpoint's ``{keystr: array}`` dict into the live ``state``
    in place (``copy_`` into the parameters, BN buffers, optimizer state
    and residuals, which keep their storage) and return it with the saved
    ``step``. The optimizer state must be of the live optimizer's kind and
    layout: per-parameter momentum (SGD, LARS), AdamW's and LAMB's ``mu``,
    ``nu`` and ``count``, or with a ``layout`` the ZeRO-1 flat state, whose
    global vectors (JAX order, at this run's extent: restore through the
    elastic remapper first) give this rank its shard. Residuals: with
    int8_ef this rank's row of ``['ef']['r1']`` and its shard of
    ``['ef']['r2']`` (zeros when the checkpoint has none, the cold start);
    without, the entries are ignored, as the JAX restore ignores entries
    its template lacks. Everything is checked before anything is copied:
    an unknown, missing or misshapen entry raises and leaves the state as
    it was. Under FSDP the full leaves are cut into this rank's shards
    (the parameters are gathered for the copy: every rank must call this
    then)."""
    if state.fsdp is not None:
        fs = state.fsdp
        full = _fsdp_opt(state, lambda entries: [
            torch.zeros_like(p, memory_format=torch.contiguous_format) for p in fs.params])
        with fs.gathered():
            out = load_train_state(dataclasses.replace(state, fsdp=None, opt_state=full), flat)
            with torch.no_grad():
                for dst, src in zip(fs.entries, fs.local_entries(fs.params)):
                    if dst is not src:
                        dst.copy_(src)
                kinds = ([("mu", "mu"), ("nu", "nu")] if _is_adam(full) else [(None, None)])
                for k, _ in kinds:
                    live = state.opt_state[k] if k else state.opt_state
                    for dst, src in zip(live, fs.local_entries(full[k] if k else full)):
                        dst.copy_(src)
        return dataclasses.replace(state, step=out.step)
    ef_saved = {k: v for k, v in flat.items() if k.startswith("['ef']")}
    tree = keystr_unflatten({k: v for k, v in flat.items() if not k.startswith("['ef']")})
    unknown = sorted(set(tree) - {"params", "bn_state", "opt_state", "step"})
    missing = sorted({"params", "opt_state", "step"} - set(tree))
    if unknown or missing:
        raise KeyError(f"checkpoint entries: unknown {unknown}, missing {missing}")
    model = state.params
    names = [n for n, _ in model.named_parameters()]
    to_sd = _from_jax_fn(model)
    if isinstance(model, ResNet):
        sd = resnet_state_dict_from_jax(tree["params"], tree.get("bn_state", {}))
    else:
        if tree.get("bn_state"):
            raise KeyError(f"a ViT has no BN state; the checkpoint has {sorted(tree['bn_state'])}")
        sd = to_sd(tree["params"])
    sd = _local(model, sd)

    def from_jax(saved):  # an optimizer tree mirroring the parameters, this rank's part
        return _local(model, to_sd(saved))

    step = np.asarray(tree["step"])
    if step.shape != () or step.dtype.kind not in "iu":
        raise ValueError(f"['step'] must be an integer scalar, got {step.dtype} {step.shape}")
    pairs = _checked_pairs(model.state_dict(), sd)
    opt, saved = state.opt_state, tree["opt_state"]
    parts = _flat_parts(state)
    flat_saved = dict(ef_saved)
    count = None
    if "['opt_state']" in parts:
        if not isinstance(saved, np.ndarray) or saved.ndim != 1:
            raise KeyError("the checkpoint's ['opt_state'] is not a ZeRO-1 flat momentum: it "
                           "was written by another optimizer or layout")
        flat_saved["['opt_state']"] = saved
    elif _is_adam(opt):
        if not isinstance(saved, dict) or set(saved) != {"mu", "nu", "count"}:
            raise KeyError("the checkpoint's ['opt_state'] is not an AdamW/LAMB state "
                           "(mu, nu, count): it was written by another optimizer")
        count = np.asarray(saved["count"])
        if count.shape != () or count.dtype.kind not in "iu":
            raise ValueError(f"['opt_state']['count'] must be an integer scalar, got "
                             f"{count.dtype} {count.shape}")
        for key in ("mu", "nu"):
            if f"['opt_state'][{key!r}]" in parts:
                if np.ndim(saved[key]) != 1:
                    raise KeyError(f"the checkpoint's ['opt_state'][{key!r}] is per leaf; this "
                                   "run keeps the ZeRO-1 flat state")
                flat_saved[f"['opt_state'][{key!r}]"] = saved[key]
                continue
            if len(opt[key]) != len(names):
                raise KeyError(f"{len(opt[key])} {key} buffers for {len(names)} parameters")
            pairs += _checked_pairs(dict(zip(names, opt[key])), from_jax(saved[key]), key)
    else:
        if len(opt) != len(names):
            raise KeyError(f"{len(opt)} momentum buffers for {len(names)} parameters")
        pairs += _checked_pairs(dict(zip(names, opt)), from_jax(saved), "momentum")
    pairs += _local_flat_pairs(state, parts, flat_saved)
    _copy_pairs(pairs)
    if count is not None:
        opt["count"].fill_(int(count))
    return dataclasses.replace(state, step=int(step))


def _local_flat_pairs(state, parts: dict, saved: dict) -> list:
    """``[(live tensor, this rank's part)]`` of each flat part: its shard
    (or row) of the saved global vector, taken back to the port's order;
    zeros for residuals the checkpoint lacks. Raises on a global length
    other than this run's extent."""
    if not parts:
        return []
    lay, order = state.layout, jax_ravel_order(state.params)
    out = []
    for key, (t, kind) in parts.items():
        arr = saved.get(key)
        if arr is None:
            if not key.startswith("['ef']"):
                raise KeyError(f"checkpoint missing array for {key}")
            out.append((t, np.zeros(tuple(t.shape), np.float32)))
            continue
        arr = np.asarray(arr, np.float32).reshape(-1)
        want = lay.world * lay.padded if kind == "row" else lay.padded
        if arr.size != want:
            raise ValueError(f"{key}: {arr.size} elements, this run's extent {lay.world} lays "
                             f"out {want}: restore through the elastic remapper")
        if kind == "row":
            part = _from_jax_order(arr.reshape(lay.world, lay.padded)[lay.rank], order)
        else:
            part = _from_jax_order(arr, order)[lay.lo:lay.lo + lay.chunk]
        out.append((t, part))
    return out
