"""The end-to-end statistics of a measured window.

A rate is all the work completed in the window over all of the window's
time. A latency tail is taken over every request due in the window, each
timed from the moment it was due to be sent (so a stall counts against
every request queued behind it); a request that failed counts as missing
the tail, as an infinite latency.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence


def rate(units: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a window of no time")
    return units / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latencies_from_due(due: Sequence[float],
                       done: Sequence[Optional[float]]) -> list:
    """Each request's latency from its due time; None (failed) is inf."""
    return [math.inf if d is None else d - s for s, d in zip(due, done)]
