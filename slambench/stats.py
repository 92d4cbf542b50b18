"""The arithmetic of the stream's host-clock metrics, over all samples."""
from __future__ import annotations

import math


def rate(count: int, seconds: float) -> float:
    return count / seconds


def mean(xs) -> float:
    xs = list(xs)
    return sum(xs) / len(xs)


def p95(xs) -> float:
    """The 95th percentile by nearest rank: the smallest sample with at
    least 95 % of all samples at or below it."""
    xs = sorted(xs)
    return xs[max(math.ceil(0.95 * len(xs)) - 1, 0)]
