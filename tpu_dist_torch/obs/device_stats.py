"""In-step training-health scalars, the device half of ``--device_metrics``:
the port's counterpart of ``tpu_dist/obs/device_stats.py``.

:func:`compute_device_stats` runs inside the train step
(``train/step.py``), on the gradients after the data-parallel reduce and
the clip: there the gradients are the same on every rank and so are the
parameters, so every statistic below is local arithmetic on the device.
The step adds no collective for them and no host read: they are appended
to the step's metrics vector after its all-reduce, and the trainer's one
fetch of that vector a logged step brings them to the host.

* ``grad_norm``: the global L2 norm of the reduced (post-clip) gradient,
  the leading indicator of a divergence (``obs/anomaly.py`` watches it).
* ``param_norm``: the global L2 norm of the parameters before the update.
* ``update_ratio``: ``‖Δparams‖ / max(‖params‖, eps)`` of this step's
  applied update (learning rate, clip and weight decay included).
* ``nonfinite_grads``: how many gradient LEAVES hold a non-finite element.

The optimizers update the parameters in place, so the step takes a flat
f32 copy of them before the update (:func:`snapshot`, only with the flag
on) and hands it in: the copy becomes the update's difference in place.
The parameters' and the difference's sums of squares are in f32, as in
the JAX file, each one reduction over the flat buffer. The host's cost
is in the passes over the leaves (each a few microseconds a leaf), so
the gradients take one: ``torch._foreach_norm`` accumulating in f64. An
f32 element's square cannot overflow f64, so a leaf's norm is non-finite
exactly when the leaf holds an inf or a NaN (the count, with no pass for
it), and the total is rounded to f32 before its square root, so that a
sum past f32's range gives inf, as JAX's f32 sum does. Scoped to the
replicated-parameter paths: under ZeRO-1 the reduced gradient exists
only as shards, and ``make_train_step`` refuses the combination, as the
JAX step does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch._utils import _flatten_dense_tensors


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The leaves raveled into one new f32 buffer (one copy kernel)."""
    leaves = [t for t in tensors if t.numel()]
    if not leaves:
        return torch.zeros(0)
    return _flatten_dense_tensors(leaves).float()


@torch.no_grad()
def snapshot(params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The parameters' flat f32 copy, taken before the in-place update and
    consumed by :func:`compute_device_stats`."""
    return _flat(params)


@torch.no_grad()
def compute_device_stats(grads, before: torch.Tensor, new_params, *,
                         eps: float = 1e-12) -> dict:
    """The ``--device_metrics`` scalars (module docstring), f32 0-d tensors
    on the leaves' device.

    ``grads`` must be the post-reduce, post-clip gradients (what the
    optimizer applied); ``before`` the parameters' :func:`snapshot` from
    before the update, and ``new_params`` the parameters after it, in the
    snapshot's order. ``before`` is consumed: it is left holding the
    negated update, ``before - new_params`` raveled."""
    grads = [g for g in grads if g.numel()]
    like = (grads or [before])[0]
    zero = torch.zeros((), dtype=torch.float32, device=like.device)
    param_norm, update_norm = zero, zero
    if before.numel():
        param_norm = torch.linalg.vector_norm(before)
        update_norm = torch.linalg.vector_norm(before.sub_(_flat(new_params)))
    grad_norm, nonfinite = zero, zero
    if grads:
        norms = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64))
        grad_norm = torch.sqrt(norms.square().sum().float())
        nonfinite = (~torch.isfinite(norms)).sum().float()
    return {
        "grad_norm": grad_norm,
        "param_norm": param_norm,
        "update_ratio": update_norm / torch.clamp(param_norm, min=eps),
        "nonfinite_grads": nonfinite,
    }
