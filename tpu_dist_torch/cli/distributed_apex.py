"""DDP + apex preset (reference ``distributed_apex.py``): bf16 compute for
apex AMP and the SyncBN that is on by default for apex's fused SyncBN,
with ``--seed 1`` unless given (``init_seeds``), as in
``tpu_dist/cli/distributed_apex.py``. Placed as the DDP preset is, by
``torchrun`` or ``tpu_dist_torch.cli.launch``."""

import sys

from tpu_dist_torch.cli.train import main as _main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--seed") for a in argv):
        argv += ["--seed", "1"]
    _main(argv, bf16=True)


if __name__ == "__main__":
    main()
