"""Gradient-accumulation preset (reference
``distributed_gradient_accumulation.py``): each rank's batch split into
``--grad_accu_steps`` chunks (4 unless given), one gradient all-reduce and
one optimizer step a step (``no_sync``), and a ``drop_last`` loader, as in
``tpu_dist/cli/distributed_gradient_accumulation.py``."""

import sys

from tpu_dist_torch.cli.train import main as _main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--grad_accu_steps") for a in argv):
        argv += ["--grad_accu_steps", "4"]
    _main(argv, drop_last=True)


if __name__ == "__main__":
    main()
