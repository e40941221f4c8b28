"""Weights across the two packages, both ways: a JAX parameter pytree (as
numpy arrays, the layout ``ViTDef.init`` / ``ResNetDef.init`` makes) to
and from the port's :class:`~tpu_dist_torch.nn.vit.ViT` or
:class:`~tpu_dist_torch.nn.resnet.ResNet` state dict, and the SGD momentum
pytree (which mirrors the parameters) to and from the port's momentum
buffers, in the model's parameter order.

* Dense ``{"w": [in, out], "b"}`` <-> Linear ``weight [out, in]``, ``bias``;
* LayerNorm ``{"scale", "bias"}`` <-> ``weight``, ``bias``;
* ViT: ``pos`` and ``blocks[i]`` map by name;
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
by :func:`keystr_flatten`.

An unknown or missing key raises. The pytree is plain nested dicts and
lists of arrays, so this module needs neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict

import numpy as np
import torch

from tpu_dist_torch.nn.resnet import ResNet
from tpu_dist_torch.nn.vit import ViT

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

    def leaf(prefix, kind):
        w, b = np.asarray(sd[f"{prefix}.weight"]), np.asarray(sd[f"{prefix}.bias"])
        return {"w": w.T, "b": b} if kind is _DENSE else {"scale": w, "bias": b}

    out = {name: leaf(name, kind) for name, kind in _TOP.items()}
    out["pos"] = np.asarray(sd["pos"])
    out["blocks"] = [{name: leaf(f"blocks.{i}.{name}", kind) for name, kind in _BLOCK.items()}
                     for i in range(depth)]
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy: an f32 CPU tensor's ``.numpy()`` would share its memory, and
    the converted pytree would follow the live weights as they train (a
    device tensor's ``.cpu()`` is a copy already)."""
    host = t.detach().float().cpu()
    return host.numpy().copy() if t.device.type == "cpu" else host.numpy()


def vit_params_to_jax(module: torch.nn.Module):
    """The module's weights as a JAX-layout ViT pytree of numpy f32 arrays."""
    return vit_state_dict_to_jax({n: _numpy(t) for n, t in module.state_dict().items()})


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
    """Copy ``{state-dict name: array}`` into ``module`` in place (on its
    device, in its dtype). Raises on any unknown, missing or misshapen
    entry."""
    _copy_pairs(_checked_pairs(module.state_dict(), sd))
    return module


def sgd_state_from_jax(module: torch.nn.Module, momentum) -> list:
    """A JAX SGD momentum pytree of a ViT -> buffers in parameter order, on
    each parameter's device and in its dtype. Raises on any unknown,
    missing or misshapen entry."""
    return _in_param_order(module, vit_state_dict_from_jax(momentum))


def load_jax_vit(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a JAX ViT pytree into ``module`` in place (on its device, in
    its dtype). Raises on any unknown, missing or misshapen entry."""
    return _load(module, vit_state_dict_from_jax(params))


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
    if isinstance(module, ViT):
        if bn_state:
            raise KeyError(f"a ViT has no BN state; got {sorted(bn_state)}")
        return load_jax_vit(module, params)
    raise TypeError(f"no JAX layout for a {type(module).__name__}: a ResNet or a ViT")


def jax_layout_template(module: torch.nn.Module):
    """``(params, bn_state)`` pytrees of ``module`` in JAX layout whose
    leaves are zero-stride f32 numpy views: every leaf's shape and dtype,
    and no copy of the weights (a restore template)."""
    sd = {n: np.broadcast_to(np.float32(0), tuple(t.shape))
          for n, t in module.state_dict().items()}
    if isinstance(module, ResNet):
        return resnet_state_dict_to_jax(sd)
    if isinstance(module, ViT):
        return vit_state_dict_to_jax(sd), {}
    raise TypeError(f"no JAX layout for a {type(module).__name__}: a ResNet or a ViT")


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


def train_state_to_flat(state) -> Dict[str, np.ndarray]:
    """A port ``TrainState`` (a ResNet's or a ViT's, SGD momentum) as the
    ``{keystr: array}`` dict of a JAX ``TrainState``: HWIO conv kernels,
    ``mean``/``var`` BN statistics, the momentum pytree mirroring the
    parameters, ``step`` as an int32 scalar; the ViT's ``bn_state`` is
    ``{}`` and ``ef`` is ``()``, so neither has an entry. An ``opt_state``
    that is one 1-D tensor is a ZeRO-1 flat momentum vector (the raveled
    parameters' momentum, padded to the data-parallel extent) and is
    written as the single entry ``['opt_state']``. Host copies: the dict
    does not follow the live tensors."""
    model = state.params
    names = [n for n, _ in model.named_parameters()]
    flat_momentum = isinstance(state.opt_state, torch.Tensor)
    if not flat_momentum and len(state.opt_state) != len(names):
        raise KeyError(f"{len(state.opt_state)} momentum buffers for {len(names)} parameters")
    sd = {n: _host_in_jax_order(t) for n, t in model.state_dict().items()}
    mom = {} if flat_momentum else {
        n: _host_in_jax_order(b) for n, b in zip(names, state.opt_state)}
    if isinstance(model, ResNet):
        params, bn_state = resnet_state_dict_to_jax(sd)
        momentum = mom and resnet_state_dict_to_jax(mom)[0]
    elif isinstance(model, ViT):
        params, bn_state, momentum = vit_state_dict_to_jax(sd), {}, mom and vit_state_dict_to_jax(mom)
    else:
        raise TypeError(f"no JAX layout for a {type(model).__name__}: a ResNet or a ViT")
    if flat_momentum:
        momentum = _numpy(state.opt_state)
    return keystr_flatten({"params": params, "bn_state": bn_state, "opt_state": momentum,
                           "step": np.asarray(state.step, np.int32), "ef": ()})


def load_train_state(state, flat: Dict[str, np.ndarray]):
    """Copy a checkpoint's ``{keystr: array}`` dict into the live ``state``
    in place (``copy_`` into the parameters, BN buffers and momentum
    buffers, which keep their storage) and return it with the saved
    ``step``. Everything is checked before anything is copied: an unknown,
    missing or misshapen entry raises and leaves the state as it was.
    Entries under ``['ef']`` (error-feedback residuals, which the port
    does not keep) are ignored, as the JAX restore ignores entries its
    template lacks."""
    tree = keystr_unflatten({k: v for k, v in flat.items() if not k.startswith("['ef']")})
    unknown = sorted(set(tree) - {"params", "bn_state", "opt_state", "step"})
    missing = sorted({"params", "opt_state", "step"} - set(tree))
    if unknown or missing:
        raise KeyError(f"checkpoint entries: unknown {unknown}, missing {missing}")
    model = state.params
    names = [n for n, _ in model.named_parameters()]
    if len(state.opt_state) != len(names):
        raise KeyError(f"{len(state.opt_state)} momentum buffers for {len(names)} parameters")
    if isinstance(model, ResNet):
        sd = resnet_state_dict_from_jax(tree["params"], tree.get("bn_state", {}))
        momentum = resnet_state_dict_from_jax(tree["opt_state"])
    elif isinstance(model, ViT):
        if tree.get("bn_state"):
            raise KeyError(f"a ViT has no BN state; the checkpoint has {sorted(tree['bn_state'])}")
        sd = vit_state_dict_from_jax(tree["params"])
        momentum = vit_state_dict_from_jax(tree["opt_state"])
    else:
        raise TypeError(f"no JAX layout for a {type(model).__name__}: a ResNet or a ViT")
    step = np.asarray(tree["step"])
    if step.shape != () or step.dtype.kind not in "iu":
        raise ValueError(f"['step'] must be an integer scalar, got {step.dtype} {step.shape}")
    pairs = (_checked_pairs(model.state_dict(), sd)
             + _checked_pairs(dict(zip(names, state.opt_state)), momentum, "momentum"))
    _copy_pairs(pairs)
    return dataclasses.replace(state, step=int(step))
