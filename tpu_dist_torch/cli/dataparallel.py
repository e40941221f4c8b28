"""DP preset (reference ``dataparallel.py``): one process, a world of one
rank on one card (or the CPU with ``--device cpu``)."""

from tpu_dist_torch.cli.train import main as _main


def main(argv=None):
    _main(argv, num_processes=1, process_id=0)


if __name__ == "__main__":
    main()
