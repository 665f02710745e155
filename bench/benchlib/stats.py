"""Statistics of a run: percentiles over every request, rates over the
whole window, the spread that sets a bound, the union of device
intervals, and seeds derived from the run's seed."""
from __future__ import annotations

import hashlib
import math
import statistics


def derive(seed: int, *labels) -> int:
    """A seed for one stream of the run's inputs: the same (seed, labels)
    always give the same 63-bit number, different labels unrelated ones."""
    digest = hashlib.sha256(repr((int(seed), *labels)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of every value:
    the smallest value that at least q% of them do not exceed. A failed
    request enters as ``math.inf`` and so misses every limit."""
    vals = sorted(values)
    if not vals:
        raise ValueError("a percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def beyond(values, q: float) -> int:
    """How many values lie above the ``q``-th percentile."""
    p = percentile(values, q)
    return sum(1 for v in values if v > p)


def rate(items: float, window_s: float) -> float:
    """Items completed over the whole window, a second."""
    if window_s <= 0:
        raise ValueError("a rate over an empty window")
    return items / window_s


def spread(values) -> float:
    """The distance between the first and the third quartile as a share of
    the median (Python's ``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


class Reservoir:
    """A uniform sample of ``size`` items out of a stream of unknown
    length, drawn from ``seed`` (Algorithm R): which items of the window
    are kept for the check depends on the seed alone."""

    def __init__(self, size: int, seed: int):
        import random

        self.size = size
        self.items: list = []
        self.seen = 0
        self._rng = random.Random(seed)

    def offer(self, make):
        """Consider the next item; ``make()`` builds it only when kept."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            j = self._rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = None  # free the one it replaces first
                self.items[j] = make()
