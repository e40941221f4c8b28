"""The program's calls that a window drives, one module an entry, named by
the traffic file's ``entry``. Each module's ``System(model, cfg, traffic,
seed, device)`` builds the program once from the seed and offers:

* ``first_steps(n)``: the first ``n`` steps through the window's own call
  and feed, on distinct batches, and the record ``check.compare`` reads;
* ``warm_up()``: whatever else the window's shapes need before it opens;
* ``call(i, steps=None)``: the window's ``i``-th call (``steps`` cuts a
  call of many steps short, for the traced sub-window), returning the
  losses of its steps as a device tensor;
* ``steps_per_call``, ``images_per_call``, ``names``, ``params()``,
  ``optimizer``, ``lr`` and ``close()``;

and the module's ``reference_batches(cfg, traffic, seed, device, n)``
draws the same ``n`` batches again for the reference, from the seed
alone. What the entries share is here.
"""

from __future__ import annotations

import socket

import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_group(device) -> bool:
    """A process group of one on ``device`` (NCCL on a card, gloo on the
    CPU), as ``Trainer.fit`` starts one on a single card; False when one
    exists already."""
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415

    _, created = mesh.initialize_distributed(device, world_size=1, rank=0,
                                             master_addr="127.0.0.1", master_port=free_port())
    return created


def leave_group(created: bool) -> None:
    if created and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def load_weights(model: torch.nn.Module, weights: dict) -> list:
    """Copy ``weights`` into ``model``'s parameters, whose names and shapes
    must be the weights' exactly; returns the names in parameter order."""
    named = dict(model.named_parameters())
    if set(named) != set(weights):
        raise ValueError(f"the port's parameters {sorted(set(named) ^ set(weights))[:6]} do not "
                         "match the benchmark's weights")
    for n, p in named.items():
        if tuple(p.shape) != tuple(weights[n].shape):
            raise ValueError(f"{n}: the port's {tuple(p.shape)}, the benchmark's "
                             f"{tuple(weights[n].shape)}")
    with torch.no_grad():
        torch._foreach_copy_(list(named.values()), [weights[n] for n in named])
    return list(named)


def optimizer(cfg: dict):
    """The configuration's optimizer, as the port's trainer builds it."""
    from tpu_dist_torch.train import optim  # noqa: PLC0415

    o = cfg["optimizer"]
    if o["name"] != "sgd":
        raise ValueError(f"{cfg['name']}: no entry drives the optimizer {o['name']!r}")
    return optim.SGD(momentum=o["momentum"], weight_decay=o["weight_decay"], fused=o["fused"])
