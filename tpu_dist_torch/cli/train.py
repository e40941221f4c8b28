"""Training CLI: the port's counterpart of ``tpu_dist/cli/train.py``.

Every flag of the JAX trainer parses (``tpu_dist_torch/config/config.py``);
one that the port cannot run yet stops with ``NotPortedError``. This
process is one rank: ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
``MASTER_ADDR``/``MASTER_PORT`` (as ``torchrun`` sets them) or
``--num_processes``/``--process_id``/``--ip``/``--port`` (as
``tpu_dist_torch.cli.launch`` passes them) place it in the process group;
alone it is a world of one. A SIGTERM ends the run at a step boundary
with the emergency snapshot and exit code 75 (``PREEMPTION_EXIT_CODE``):
resume with ``--resume``.

Usage::

    python -m tpu_dist_torch.cli.train --batch_size 256 --epochs 200 --lr 0.1
    python -m tpu_dist_torch.cli.train --device cpu --dataset synthetic ...
    python -m tpu_dist_torch.cli.train --optimizer lars --lr_base_batch 256 \
        --warmup_epochs 1 --remat ...

The rank-0 start line names the optimizer, ``remat`` and the input
pipeline that feeds the run: ``input=native (...)``, or ``input=numpy
(<why the C++ library is not there>)``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from tpu_dist_torch.config.config import add_reference_flags, config_from_args
from tpu_dist_torch.metrics.logging import rank0_print
from tpu_dist_torch.resilience.preemption import PREEMPTION_EXIT_CODE, PreemptedError


def parse(argv: Optional[Sequence[str]] = None, **preset):
    parser = argparse.ArgumentParser(description="tpu_dist_torch trainer (DDP over NCCL)")
    add_reference_flags(parser)
    return config_from_args(parser.parse_args(argv), **preset)


def main(argv: Optional[Sequence[str]] = None, **preset) -> None:
    cfg = parse(argv, **preset)
    from tpu_dist_torch.train.trainer import Trainer  # noqa: PLC0415

    trainer = Trainer(cfg)
    try:
        rank0_print(
            f"tpu_dist_torch: model={cfg.model} ranks={trainer.n_devices} "
            f"device={trainer.device.type} global_batch={cfg.batch_size} bf16={cfg.bf16} "
            f"sync_bn={cfg.sync_bn} grad_accu_steps={cfg.grad_accu_steps} "
            f"fused_optimizer={cfg.fused_optimizer} optimizer={cfg.optimizer} "
            f"remat={cfg.remat} input={trainer.input_pipeline}"
        )
        trainer.fit()
    except PreemptedError as e:
        # fit() wrote the emergency snapshot; exit with the requeue-me code
        rank0_print(f"=> preempted: {e}; exiting {PREEMPTION_EXIT_CODE}")
        raise SystemExit(PREEMPTION_EXIT_CODE) from None
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
