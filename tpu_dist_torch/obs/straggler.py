"""Per-rank straggler detection: the port's counterpart of
``tpu_dist/obs/straggler.py``.

One slow rank drags every step of a data-parallel run, because the
gradient all-reduce marches at the slowest rank's pace. At each epoch's
end every rank's ``(epoch_time, data_stall_frac)`` is gathered and the
largest epoch time is compared with the median.

The gather is a collective: every rank calls :func:`epoch_skew` at the
same point (the trainer does, after each epoch's ``train_epoch`` record).
By default it is one all-gather of a 2-element f64 tensor through
``comm/collectives.py``, counted as ``comm.all_gather.straggler``; at a
world of one there is no collective (a one-rank run's counts do not
move), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tpu_dist_torch.comm import collectives
from tpu_dist_torch.metrics.logging import rank0_print
from tpu_dist_torch.obs import counters


def _default_allgather(row: np.ndarray) -> np.ndarray:
    """Every rank's ``row`` stacked in rank order, ``(world, 2)``."""
    if collectives.world_size() <= 1:
        return row[None, :]
    x = torch.as_tensor(row, dtype=torch.float64, device=collectives.group_device())
    out = collectives.all_gather_flat(x, kind="straggler")
    return out.cpu().numpy().reshape(-1, row.shape[0])


def epoch_skew(
    epoch_time: float,
    stall_frac: float = 0.0,
    *,
    epoch: Optional[int] = None,
    threshold: float = 1.5,
    allgather: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> dict:
    """Gather this rank's epoch wall time and stall fraction, compute the
    max/median skew, and warn on rank 0 when it exceeds ``threshold``.

    COLLECTIVE: every rank must reach this call once an epoch.
    ``allgather`` is injectable for tests (rows of ``[time, stall]``).
    Returns the skew record (what the trainer logs to its history)::

        {"skew": 1.8, "straggler": True, "worst_rank": 3,
         "median_s": 10.2, "max_s": 18.4,
         "epoch_times": [...], "stall_fracs": [...]}
    """
    gather = allgather or _default_allgather
    rows = np.asarray(
        gather(np.asarray([epoch_time, stall_frac], np.float64)), np.float64
    ).reshape(-1, 2)
    times, stalls = rows[:, 0], rows[:, 1]
    median = float(np.median(times))
    worst = int(np.argmax(times))
    skew = float(times[worst] / median) if median > 0 else 1.0
    rec = {
        "skew": round(skew, 4),
        "straggler": bool(threshold > 0 and skew > threshold),
        "worst_rank": worst,
        "median_s": round(median, 4),
        "max_s": round(float(times[worst]), 4),
        "epoch_times": [round(float(t), 4) for t in times],
        "stall_fracs": [round(float(s), 4) for s in stalls],
    }
    if rec["straggler"]:
        counters.inc("straggler.epochs_flagged")
        rank0_print(
            f"WARNING: straggler detected{f' (epoch {epoch})' if epoch is not None else ''}: "
            f"process {worst} took {rec['max_s']:.2f}s vs median "
            f"{rec['median_s']:.2f}s ({skew:.2f}x > threshold {threshold}x); "
            f"its data-stall fraction is {float(stalls[worst]):.2%} — "
            "check that host's input pipeline/disk before blaming the model"
        )
    return rec
