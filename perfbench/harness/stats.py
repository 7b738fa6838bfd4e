"""Order statistics of a window's samples."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest sample with at
    least ``q`` percent of all samples at or below it."""
    if not values:
        raise ValueError("no samples in the window")
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)) - 1, 0)]


def p95(values: Sequence[float]) -> float:
    return percentile(values, 95.0)
