"""Weights across the two packages, both ways: a JAX ViT parameter pytree
(as numpy arrays, the layout ``tpu_dist.nn.vit.ViTDef.init`` makes) to
and from the port's :class:`~tpu_dist_torch.nn.vit.ViT` state dict, and
the SGD momentum pytree (which mirrors it) to and from the port's
momentum buffers.

* Dense ``{"w": [in, out], "b"}`` <-> Linear ``weight [out, in]``, ``bias``;
* LayerNorm ``{"scale", "bias"}`` <-> ``weight``, ``bias``;
* ``pos`` and ``blocks[i]`` map by name.

An unknown or missing key raises. The pytree is plain nested dicts and
lists of arrays, so this module needs neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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
    return t.detach().float().cpu().numpy()


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


def sgd_state_from_jax(module: torch.nn.Module, momentum) -> list:
    """A JAX SGD momentum pytree -> buffers in parameter order, on each
    parameter's device and in its dtype. Raises on any unknown, missing or
    misshapen entry."""
    sd = vit_state_dict_from_jax(momentum)
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


def load_jax_vit(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a JAX ViT pytree into ``module`` in place (on its device, in
    its dtype). Raises on any unknown, missing or misshapen entry."""
    sd = vit_state_dict_from_jax(params)
    own = module.state_dict()
    unknown = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    if unknown or missing:
        raise KeyError(f"state dict mismatch: unknown {unknown}, missing {missing}")
    for name, arr in sd.items():
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(
                f"{name}: JAX shape {tuple(arr.shape)} vs port shape "
                f"{tuple(own[name].shape)}"
            )
    with torch.no_grad():
        for name, arr in sd.items():
            dst = own[name]
            dst.copy_(torch.as_tensor(np.array(arr, dtype=np.float32)).to(dst.dtype))
    return module


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
