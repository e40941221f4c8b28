"""Distributed evaluation: the port's counterpart of
``tpu_dist/evaluation/validate.py``.

The eval step returns sums already reduced over the process group; here
they are fetched once per batch, summed, and divided once at the end, so
every real test example counts exactly once (padded slots carry a 0 mask)
on every rank.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from tpu_dist_torch.metrics.logging import rank0_print
from tpu_dist_torch.metrics.meters import AverageMeter, ProgressMeter
from tpu_dist_torch.obs import counters, spans

SUMS = ("loss", "top1", "top5", "count")


def validate(loader, state, eval_step: Callable, *, log_every: int = 50,
             epoch: Optional[int] = None):
    """Returns ``(top1, top5, loss)`` as floats (global, exact).

    ``loader`` yields ``(images, labels, mask)`` batches
    (``DataLoader(with_mask=True)``); ``eval_step`` comes from
    :func:`tpu_dist_torch.train.step.make_eval_step`. The counter
    ``eval.examples`` grows by the number of real examples counted."""
    batch_time = AverageMeter("Time", ":6.3f")
    losses = AverageMeter("Loss", ":.4e")
    top1 = AverageMeter("Acc@1", ":6.2f")
    top5 = AverageMeter("Acc@5", ":6.2f")
    progress = ProgressMeter(len(loader), batch_time, losses, top1, top5, prefix="Test: ")

    tot = dict.fromkeys(SUMS, 0.0)
    t_eval = time.perf_counter()
    end = time.time()
    for i, (images, labels, mask) in enumerate(loader):
        out = eval_step(state, images, labels, mask)
        # ONE device->host transfer per batch
        sums = dict(zip(SUMS, torch.stack([out[k] for k in SUMS]).tolist()))
        n = max(sums["count"], 1.0)
        for k in tot:
            tot[k] += sums[k]
        losses.update(sums["loss"] / n, int(n))
        top1.update(sums["top1"] / n * 100.0, int(n))
        top5.update(sums["top5"] / n * 100.0, int(n))
        batch_time.update(time.time() - end)
        end = time.time()
        if i % log_every == 0:
            progress.display(i)

    n = max(tot["count"], 1.0)
    t1, t5, loss = tot["top1"] / n * 100.0, tot["top5"] / n * 100.0, tot["loss"] / n
    spans.add_event("eval/validate", t_eval, time.perf_counter() - t_eval, epoch=epoch)
    counters.inc("eval.runs")
    counters.inc("eval.examples", tot["count"])
    rank0_print(f" * Acc@1 {t1:.3f} Acc@5 {t5:.3f}"
                + (f" (epoch {epoch})" if epoch is not None else ""))
    return t1, t5, loss
