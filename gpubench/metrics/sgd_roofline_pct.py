"""The optimizer's share of its roofline: the configuration's optimizer
update (``tpu_dist_torch.train.optim.SGD`` with ``fused=True``: one launch
of the fused SGD kernel) over copies of the cell's own parameter leaves,
with gradients and momentum of their shapes, timed alone with CUDA events
behind a head start. Its bytes are the parameters, gradients and momentum
read and the parameters and momentum written (``gpubench.flops.sgd_bytes``)
at the HBM peak."""

import torch

from gpubench import flops, timing, traffic as gen


def read(run):
    if run.device.type != "cuda":
        return None
    system = run.system
    params = [p.detach().clone() for p in system.params()]
    g = gen.generator(0, "sgd", run.device)
    grads = [torch.randn(p.shape, generator=g, device=run.device) * 1e-3 for p in params]
    bufs = [torch.zeros_like(p) for p in params]
    seconds = timing.device_seconds(lambda: system.optimizer.update(grads, bufs, params, 1e-3))
    return flops.roofline_pct(0, flops.sgd_bytes(sum(p.numel() for p in params)), seconds)
