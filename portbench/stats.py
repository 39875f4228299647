"""The arithmetic of the end-to-end metrics."""
from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all values."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def window_rate(total_s: float, count: int) -> float:
    """Milliseconds per unit: all the window's time over all its units."""
    if count <= 0:
        raise ValueError("no unit completed in the window")
    return total_s * 1e3 / count

