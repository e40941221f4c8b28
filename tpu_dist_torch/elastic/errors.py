"""Typed restore-ladder errors: the port's copy of
``tpu_dist/elastic/errors.py``.

* :class:`ElasticShapeMismatch`: benign. A leaf's shape differs only as a
  different data-parallel extent makes it differ (a ZeRO-1 flat optimizer
  vector, an error-feedback residual); a restore with a
  :class:`~tpu_dist_torch.elastic.remap.Remapper` rebuilds it.
* :class:`ConfigMismatchError`: the checkpoint belongs to another run
  (another model, layout stamp or data position). The ladder raises it;
  resuming past it would train the wrong run.

Both subclass ``ValueError``. This module imports nothing, so it sits
below ``tpu_dist_torch.ckpt`` and ``elastic.remap`` alike; the checkpoint
module re-exports :class:`ConfigMismatchError`, so one class is caught on
either path.
"""

from __future__ import annotations


class ConfigMismatchError(ValueError):
    """A readable checkpoint that this run must not resume: another model,
    pipeline layout, batch size or seed. The restore ladder raises it; it
    never quarantines it."""


class ElasticShapeMismatch(ValueError):
    """A leaf's checkpointed shape differs from the template only because
    the run's data-parallel extent changed; restore with an elastic
    remapper."""

    def __init__(self, key: str, ckpt_shape, want_shape):
        self.key = key
        self.ckpt_shape = tuple(ckpt_shape)
        self.want_shape = tuple(want_shape)
        super().__init__(
            f"elastic shape mismatch for {key}: ckpt {self.ckpt_shape} vs "
            f"state {self.want_shape} — a dp-extent-dependent leaf saved at "
            "a different world size; restore with an elastic remapper"
        )
