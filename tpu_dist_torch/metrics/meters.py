"""Running-average meters and progress display: the port's copy of
``tpu_dist/metrics/meters.py`` (the reference's ``utils/util.py`` display
contract, ``loss 1.23 (1.50)`` and ``[ 12/196]``). Meters see host
scalars that the step already reduced across ranks; only rank 0 prints a
progress line.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tpu_dist_torch.comm import mesh


@dataclass
class AverageMeter:
    """Tracks the latest value and the n-weighted running mean of a scalar.

    ``fmt`` is a format spec (with or without the leading ``:``) applied to
    both the latest and the mean value in ``str(meter)``.
    """

    name: str
    fmt: str = ":f"
    _total: float = field(default=0.0, repr=False)
    _weight: int = field(default=0, repr=False)
    _latest: float = field(default=0.0, repr=False)

    @property
    def val(self) -> float:
        return self._latest

    @property
    def sum(self) -> float:
        return self._total

    @property
    def count(self) -> int:
        return self._weight

    @property
    def avg(self) -> float:
        return self._total / self._weight if self._weight else 0.0

    def reset(self) -> None:
        self._total, self._weight, self._latest = 0.0, 0, 0.0

    def update(self, val: float, n: int = 1) -> None:
        self._latest = float(val)
        self._total += self._latest * n
        self._weight += n

    def __str__(self) -> str:
        spec = self.fmt.lstrip(":")
        return f"{self.name} {format(self.val, spec)} ({format(self.avg, spec)})"


class ProgressMeter:
    """Prints a tab-joined progress line: a ``[ cur/total]`` step counter
    (current padded to total's width) followed by each meter's ``str``."""

    def __init__(self, num_batches: int, *meters: AverageMeter, prefix: str = ""):
        self.num_batches = num_batches
        self.meters = list(meters)
        self.prefix = prefix

    def _counter(self, batch: int) -> str:
        total = str(self.num_batches)
        return f"[{str(batch).rjust(len(total))}/{total}]"

    def display(self, batch: int) -> str:
        line = "\t".join([self.prefix + self._counter(batch), *map(str, self.meters)])
        if mesh.is_primary():
            print(line, flush=True)
        return line
