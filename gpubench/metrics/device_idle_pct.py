"""The share of the traced sub-window in which no kernel, memcpy or
memset ran on the card."""


def read(run):
    if run.traced is None or not run.traced["device_events"]:
        return None
    return 100.0 * (1.0 - run.traced["busy_s"] / run.traced["window_s"])
