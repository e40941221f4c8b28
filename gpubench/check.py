"""What ``correct`` compares: the program's first steps against the plain
reference's, from the same weights and the same batches.

The numbers, each compared where ``limits/<workload>.json`` gives it a
limit of its own (with the readings the limit was set from):

* ``loss_gap``: the largest gap of a step's loss, as a share of the
  reference's loss of that step (``loss_gap_first``: the first step's);
* ``grad_gap``: the worst leaf's gap between the norm of its first
  gradient, as the optimizer got it (the program's momentum after one step
  less the weight decay of the starting weights), and the reference's;
* ``update_gap``: the worst leaf's gap between the norm of its change over
  the compared steps and the reference's;
* ``grad_gap_median`` and ``update_gap_median``: the median leaf's gaps of
  the same two, steady from seed to seed where the worst leaf is a small
  leaf whose gradient bf16 rounding moves by itself.

A leaf's gap is measured against the reference's norm of that leaf or of
the median leaf, whichever is larger. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of ``update_gap``.
"""

from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("loss_gap", "loss_gap_first", "grad_gap", "update_gap", "grad_gap_median",
           "update_gap_median")
STILL = 1e-3  # a leaf whose gradient is under this share of the median leaf's


def flat_copy(tensors) -> list:
    """Detached copies of ``tensors``."""
    return [t.detach().clone() for t in tensors]


def grad_norms(names, momentum, start, weight_decay: float) -> dict:
    """Each leaf's first gradient from its momentum after one step from
    zero (``b = g + wd·p``) and its starting value ``start``."""
    with torch.no_grad():
        return {n: float(torch.linalg.vector_norm(b.float() - weight_decay * p.float()))
                for n, b, p in zip(names, momentum, start)}


def delta_norms(names, params, start) -> dict:
    with torch.no_grad():
        return {n: float(torch.linalg.vector_norm(p.float() - s.float()))
                for n, p, s in zip(names, params, start)}


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """Each leaf's gap of norms, against the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves}


def moving_leaves(ref: dict) -> list:
    """The leaves whose reference gradient is at least :data:`STILL` of the
    median leaf's."""
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    return [n for n in g if g[n] >= STILL * med]


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of :data:`NUMBERS`, from two records of ``{"losses",
    "grad_norms", "delta_norms"}`` (the program's or the control's, and
    the reference's). A record whose leaves differ raises."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program's leaves are not the reference's")
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError(f"{len(prog['losses'])} program steps, {len(ref['losses'])} reference")
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    g = ref["grad_norms"]
    grad = list(leaf_gaps(prog["grad_norms"], g, list(g)).values())
    update = list(leaf_gaps(prog["delta_norms"], ref["delta_norms"], moving_leaves(ref)).values())
    return {"loss_gap": max(losses), "loss_gap_first": losses[0],
            "grad_gap": max(grad), "update_gap": max(update),
            "grad_gap_median": statistics.median(grad),
            "update_gap_median": statistics.median(update)}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number that has a limit finite and at most it."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= v for k, v in limits.items())
