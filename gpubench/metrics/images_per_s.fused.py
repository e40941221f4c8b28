"""The fused-epoch cells' rate, read as :mod:`gpubench.metrics.images_per_s`
reads it (every image trained in the window over the window's time),
under a name of its own whose bound is set from those cells' own spread:
the host paces some of their graph replays, so their runs spread far
wider than the streaming step's."""

from gpubench.metrics.images_per_s import read  # noqa: F401
