"""Debug-mode cross-replica consistency checks: the port's counterpart of
``tpu_dist/metrics/consistency.py``.

What can still go wrong once every step is a fixed sequence of collectives
is replica state divergence: a rank whose copy of a nominally replicated
tensor drifted (host input that differs between ranks, a collective left
out of a custom step). :func:`check_replicated` detects exactly that: every
rank's copy of each tensor is compared with the group's first rank's copy,
bit for bit by default.

The group is the ranks that hold the same copies: the trainer's
``replicas`` (the ranks that share a model index under ``--tp``, ``--ep``
or ``--pp``), else the world (data x seq under ``--sp``). A TP shard is
compared only among the ranks that hold that shard, never across model
ranks, as JAX's check skips a leaf whose devices hold different shards.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tpu_dist_torch.comm import collectives


def _jax_keys(module: torch.nn.Module) -> Dict[str, str]:
    """``{state-dict name: JAX keystr}`` of the module's leaves (a pipelined
    stage's rows with their row index); empty for a module with no JAX
    layout."""
    from tpu_dist_torch import bridge  # noqa: PLC0415

    try:
        layout = bridge.leaf_layout(module)
    except TypeError:
        return {}
    return {name: lay.key + (f"[{lay.row}]" if lay.row is not None else "")
            for name, lay in layout.items()}


def _same(a: np.ndarray, b: np.ndarray, atol: float) -> bool:
    if atol == 0.0:
        return np.array_equal(a, b, equal_nan=True)
    return np.allclose(a, b, atol=atol, equal_nan=True)


def check_replicated(module_or_tensors, name: str = "state", atol: float = 0.0,
                     group=None) -> None:
    """Assert every tensor is the same on all ranks of ``group`` (None: the
    world). ``module_or_tensors`` is a module (its parameters, under their
    JAX keys where the module has a JAX layout) or a dict of tensors (under
    its keys). One all-gather over the group of all the tensors, raveled
    (f64, exact for f32 and bf16 values); each rank's copy is compared with
    the group's first rank's, bit for bit (``atol=0``, NaN equal to NaN) or
    within ``atol``. Raises ``AssertionError`` naming the first diverging
    tensor (in order), the two ranks (the default group's) and the max abs
    difference. Every rank of the group must call it. For debug runs and
    tests, not the hot loop."""
    if isinstance(module_or_tensors, torch.nn.Module):
        keys = _jax_keys(module_or_tensors)
        tensors = {keys.get(n, f"[{n!r}]"): t for n, t in module_or_tensors.named_parameters()}
    else:
        tensors = {k if k.startswith("[") else f"[{k!r}]": t for k, t in module_or_tensors.items()}
    n = collectives.world_size(group)
    if n <= 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors.values()])
    every = collectives.all_gather_flat(flat, group=group, kind="replica_check")
    every = every.cpu().numpy().reshape(n, -1)
    bounds = np.cumsum([0] + [t.numel() for t in tensors.values()])
    for r in range(1, n):
        if _same(every[0], every[r], atol):
            continue
        for i, key in enumerate(tensors):
            a, b = every[0, bounds[i]:bounds[i + 1]], every[r, bounds[i]:bounds[i + 1]]
            if not _same(a, b, atol):
                raise AssertionError(
                    f"replica divergence in {name}{key}: rank "
                    f"{collectives.global_rank(group, 0)} vs "
                    f"{collectives.global_rank(group, r)} (max abs diff "
                    f"{np.max(np.abs(a - b)):.3e})")


def check_state(state, group: Optional[object] = None) -> None:
    """The trainer's epoch-end check (``debug_replica_check``): the
    parameters, then the BatchNorm statistics (``bn_state``, under their
    JAX keys), over ``group``."""
    check_replicated(state.params, "params", group=group)
    if state.bn_state:
        keys = _jax_keys(state.params)
        check_replicated({keys.get(k, f"[{k!r}]"): v for k, v in state.bn_state.items()},
                         "bn_state", group=group)
