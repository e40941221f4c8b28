"""The whole step's share of the card's bf16 peak: the cell's model FLOPs
a step (``gpubench.flops``, from its shapes) times the steps of the
measured window, over the window's time, over 989.4 TFLOP/s. The traced
sub-window comes after the measured window and is not part of it."""

from gpubench import flops


def read(run):
    if run.device.type != "cuda":
        return None
    rate = flops.train_flops(run.cfg, run.traffic) * run.window["steps"] / run.window["seconds"]
    return 100.0 * rate / flops.PEAK_BF16_FLOPS
