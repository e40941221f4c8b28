"""``device_busy_ms`` (the device's busy time a step) in the fused-epoch cells, read as
:mod:`gpubench.metrics.device_busy_ms` reads it, under a name of its own: those
cells' end-to-end rate is ``images_per_s.fused``, whose bound is set from
their own spread (the host paces some of their graph replays, so their
runs spread far wider than the streaming step's)."""

from gpubench.metrics.device_busy_ms import read  # noqa: F401
