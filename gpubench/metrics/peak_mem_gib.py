"""The allocator's peak over the window (reset as it opens): the device
memory a user has to fit."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.window["peak_bytes"] / 2 ** 30
