"""Every image trained in the window over the window's time (its end is
the ``synchronize`` after the last call)."""

from gpubench import stats


def read(run):
    return stats.rate(run.window["images"], run.window["seconds"])
