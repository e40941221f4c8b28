"""The 90th percentile over every step of the window of the device time
between the events recorded after consecutive steps (waits for the host
included). A call that holds many steps (the fused epoch) has no step
time of its own here."""

from gpubench import stats


def read(run):
    if run.system.steps_per_call != 1 or run.device.type != "cuda":
        return None
    return stats.quantile(run.window["call_ms"], 0.9)
