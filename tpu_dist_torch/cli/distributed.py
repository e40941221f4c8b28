"""DDP preset for ``torchrun`` (reference ``distributed.py`` under
``torch.distributed.launch``): one process per card, placed by the
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``
that the launcher sets; ``--local_rank`` parses for parity::

    torchrun --nproc_per_node 4 -m tpu_dist_torch.cli.distributed --batch_size 256
"""

from tpu_dist_torch.cli.train import main as _main


def main(argv=None):
    _main(argv)


if __name__ == "__main__":
    main()
