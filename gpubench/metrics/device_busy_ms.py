"""Device busy time a step in the traced sub-window: the union of the
kernel, memcpy and memset intervals on the card, over its steps."""


def read(run):
    if run.traced is None or not run.traced["device_events"]:
        return None
    return 1e3 * run.traced["busy_s"] / run.traced["steps"]
