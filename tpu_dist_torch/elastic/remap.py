"""Checkpoint leaves whose shape bakes in the data-parallel extent, rebuilt
for another extent: the port's copy of ``tpu_dist/elastic/remap.py``.

Parameters, BN statistics and per-leaf momentum have shapes that never
mention the mesh. Three leaf families do, because they are flat vectors
padded to a length divisible by the extent ``n``
(:func:`tpu_dist_torch.comm.quantize.padded_len`):

* ZeRO-1 flat optimizer state, ``(ceil(L/n)*n,)``: the first ``L``
  entries are the raveled parameters' state and the pad tail is zero.
  Remapped bit for bit: the prefix copied, both tails zero; a nonzero
  source tail raises.
* ``ef['r1']``, ``(n*P,)`` with ``P = padded_len(L, n)``: one row of
  quantization error per replica. The rows' ``[:L]`` columns are summed
  into new replica 0's row: the total the next reduce adds is kept to the
  bit, its split between replicas is not.
* ``ef['r2']``, ``(P,)``: cropped to ``L`` and re-padded with zeros.

The remapper is the host-side hook that
:func:`tpu_dist_torch.ckpt.restore` calls on a shape mismatch. Pure numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tpu_dist_torch.elastic.errors import ConfigMismatchError, ElasticShapeMismatch

__all__ = [
    "ConfigMismatchError",
    "ElasticShapeMismatch",
    "Remapper",
    "classify",
    "elastic_stamp",
    "make_remapper",
    "params_len",
]

_EF_R1_PREFIX = "['ef']['r1']"
_EF_R2_PREFIX = "['ef']['r2']"
_OPT_PREFIX = "['opt_state']"


def params_len(params) -> int:
    """Length ``L`` of the raveled parameter vector, the coordinate every
    elastic flat layout is padded from: of a module (its parameters) or of
    a parameter pytree (nested dicts, lists and arrays)."""
    if hasattr(params, "parameters"):  # a torch.nn.Module
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(params_len(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(params_len(v) for v in params)
    return int(np.prod(np.shape(params)))


def elastic_stamp(n_data: int, procs: int, L: int) -> dict:
    """The ``elastic`` checkpoint-meta stamp: the data-parallel extent the
    state was laid out for, the process count and the parameter length."""
    return {"dp": int(n_data), "procs": int(procs), "params_len": int(L)}


def classify(
    key: str, ckpt_shape: Tuple[int, ...], want_shape: Tuple[int, ...], L: int
) -> Optional[str]:
    """Which elastic family explains a ``ckpt_shape`` vs ``want_shape``
    mismatch on ``key``: ``'zero1_flat'``, ``'ef_r1'``, ``'ef_r2'``, or
    None (a real configuration mismatch)."""
    if key.startswith(_EF_R1_PREFIX):
        return "ef_r1"
    if key.startswith(_EF_R2_PREFIX):
        return "ef_r2"
    if (
        key.startswith(_OPT_PREFIX)
        and len(ckpt_shape) == 1
        and len(want_shape) == 1
        and ckpt_shape[0] >= L
        and want_shape[0] >= L
    ):
        return "zero1_flat"
    return None


class Remapper:
    """Shape-mismatch hook for :func:`tpu_dist_torch.ckpt.restore`: rebuilds
    the extent-dependent leaves at the new extent ``n_new``. ``used`` lists
    every ``(key, kind)`` it remapped, in the restore's leaf order."""

    def __init__(self, L: int, n_new: int, n_old: Optional[int] = None):
        if L <= 0:
            raise ValueError(f"params_len must be positive, got {L}")
        if n_new <= 0:
            raise ValueError(f"n_new must be positive, got {n_new}")
        self.L = int(L)
        self.n_new = int(n_new)
        self.n_old = int(n_old) if n_old is not None else None
        self.used: list = []

    def __call__(self, key: str, arr: np.ndarray, leaf) -> Optional[np.ndarray]:
        want = tuple(np.shape(leaf))
        arr = np.asarray(arr)
        kind = classify(key, tuple(arr.shape), want, self.L)
        if kind is None:
            return None
        out = getattr(self, f"_remap_{kind}")(key, arr.ravel(), int(np.prod(want)))
        self.used.append((key, kind))
        return out.reshape(want)

    def _remap_zero1_flat(self, key: str, arr: np.ndarray, want: int) -> np.ndarray:
        L = self.L
        if want < L:
            raise ConfigMismatchError(
                f"{key}: target flat length {want} is shorter than the "
                f"logical param length {L} — not a world-size change"
            )
        if arr[L:].any():
            # the pad tail is zero by construction; nonzero means another
            # layout, and dropping it would lose optimizer state
            raise ConfigMismatchError(
                f"{key}: flat optimizer vector has nonzero entries past the "
                f"logical param length {L} — the checkpoint's layout does "
                "not match the ZeRO-1 elastic contract; refusing to remap"
            )
        out = np.zeros((want,), arr.dtype)
        out[:L] = arr[:L]
        return out

    def _remap_ef_r1(self, key: str, arr: np.ndarray, want: int) -> np.ndarray:
        if self.n_old is None:
            raise ConfigMismatchError(
                f"{key}: checkpoint predates the elastic 'dp' stamp, so the "
                "per-replica row count of the r1 residuals is unknown — "
                "resume at the original world size once (re-stamping), or "
                "drop to a clean-epoch checkpoint"
            )
        if arr.size % self.n_old:
            raise ConfigMismatchError(
                f"{key}: r1 length {arr.size} does not divide into "
                f"{self.n_old} replica rows — stamp/layout disagreement"
            )
        p_old = arr.size // self.n_old
        if want % self.n_new:
            raise ConfigMismatchError(
                f"{key}: target r1 length {want} does not divide into "
                f"{self.n_new} replica rows"
            )
        p_new = want // self.n_new
        crop = min(self.L, p_old, p_new)
        # the reduce sums every replica's row, so folding all rows into
        # replica 0 keeps the total; columns past L chase pad coordinates
        total = arr.reshape(self.n_old, p_old)[:, :crop].sum(axis=0, dtype=arr.dtype)
        out = np.zeros((want,), arr.dtype)
        out[:crop] = total
        return out

    def _remap_ef_r2(self, key: str, arr: np.ndarray, want: int) -> np.ndarray:
        keep = min(self.L, arr.size, want)
        out = np.zeros((want,), arr.dtype)
        out[:keep] = arr[:keep]
        return out


def make_remapper(template_params, meta: Optional[dict], n_new: int) -> Remapper:
    """The restore ladder's remapper for one checkpoint candidate: ``L``
    from the live parameters (a module or a pytree), ``n_old`` from the
    checkpoint's ``elastic`` stamp (None before the stamp existed; only
    ``r1`` needs it). A stamped ``params_len`` other than ``L`` is another
    model: :class:`ConfigMismatchError`."""
    L = params_len(template_params)
    el = (meta or {}).get("elastic") or {}
    stamped = el.get("params_len")
    if stamped is not None and int(stamped) != L:
        raise ConfigMismatchError(
            f"checkpoint was written with params_len={stamped} but the live "
            f"model ravels to {L} parameters — a different model, not a "
            "world-size change; elastic remap refused"
        )
    return Remapper(L, n_new, n_old=el.get("dp"))
