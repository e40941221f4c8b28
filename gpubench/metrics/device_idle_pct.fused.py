"""``device_idle_pct`` (the traced sub-window's idle share) in the fused-epoch cells, read as
:mod:`gpubench.metrics.device_idle_pct` reads it, under a name of its own: those
cells' end-to-end rate is ``images_per_s.fused``, whose bound is set from
their own spread (the host paces some of their graph replays, so their
runs spread far wider than the streaming step's)."""

from gpubench.metrics.device_idle_pct import read  # noqa: F401
