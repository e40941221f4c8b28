"""DP + AMP preset (reference ``dataparallel_apex.py``): the DP preset
(one process, a world of one rank) with bf16 compute standing in for
apex AMP, as in ``tpu_dist/cli/dataparallel_apex.py`` (bf16 keeps f32's
exponent range, so there is no loss scaling)."""

from tpu_dist_torch.cli.train import main as _main


def main(argv=None):
    _main(argv, num_processes=1, process_id=0, bf16=True)


if __name__ == "__main__":
    main()
