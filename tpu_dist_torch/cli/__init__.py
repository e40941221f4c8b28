"""Command-line entry points: ``python -m tpu_dist_torch.cli.<name>``."""
