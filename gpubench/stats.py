"""The arithmetic of a window: rates, percentiles over every sample, and
intervals on the device's timeline. Plain Python, so the CPU tests hold it."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def quantile(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile (0 to 1) of every value, interpolated linearly
    between the two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work over the time it took."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> list:
    """The parts of ``intervals`` inside ``[lo, hi]``."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def busy(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(b - a for a, b in merge(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> list:
    """The idle ``(start, end)`` stretches of ``[lo, hi]`` that no
    interval covers."""
    out, t = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def idle_pct(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """The share of ``[lo, hi]`` that no interval covers, in percent."""
    return 100.0 * (1.0 - busy(intervals, lo, hi) / (hi - lo))


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``'s quartiles)."""
    import statistics  # noqa: PLC0415

    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
