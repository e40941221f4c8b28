"""Spawn-mode DDP preset (reference ``distributed_mp.py``, the reference's
recommended path): this process starts one rank per visible card with
``torch.multiprocessing.spawn`` (``--num_processes`` ranks instead, which
``--device cpu`` needs to run more than one) and each rank runs the
trainer over NCCL (gloo on the CPU), rendezvousing at ``--ip``/``--port``.
As in the JAX preset, ``--seed 1`` is the default (the reference's
``init_seeds(local_rank + 1)``). A rank that exits 75 (preempted, its
snapshot written) makes this process exit 75 too::

    python -m tpu_dist_torch.cli.distributed_mp --dataset synthetic --epochs 1
"""

from __future__ import annotations

import os
import sys

from tpu_dist_torch.cli.train import main as _main
from tpu_dist_torch.cli.train import parse
from tpu_dist_torch.comm import mesh
from tpu_dist_torch.resilience.preemption import PREEMPTION_EXIT_CODE


def _rank(rank: int, argv: list, world: int, addr: str, port: int) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR=addr, MASTER_PORT=str(port))
    _main(argv)


def main(argv=None) -> None:
    import torch.multiprocessing as mp  # noqa: PLC0415

    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--seed") for a in argv):
        argv += ["--seed", "1"]
    cfg = parse(argv)
    world = cfg.num_processes or mesh.local_device_count(cfg.device)
    if world < 1:
        raise SystemExit(f"no {cfg.device} device to start a rank on")
    try:
        mp.spawn(_rank, args=(argv, world, cfg.ip, cfg.port), nprocs=world, join=True)
    except mp.ProcessExitedException as e:
        if e.exit_code == PREEMPTION_EXIT_CODE:
            raise SystemExit(PREEMPTION_EXIT_CODE) from None
        raise


if __name__ == "__main__":
    main()
