"""Arithmetic the readers of ``bench/metrics/`` share."""
from __future__ import annotations

import statistics

from benchlib import stats


def window_rate(r) -> float | None:
    """Items (keys or prompt tokens) of every call that completed in the
    window, over the window's seconds."""
    if r.window_s is None or not r.calls:
        return None
    return stats.rate(sum(c["items"] for c in r.calls if c["ok"]), r.window_s)


def tail_ms(r, q: float) -> float | None:
    """The q-th percentile, over every call of the window, of its time, in
    ms (a failed call is infinitely long)."""
    if not r.calls:
        return None
    return stats.percentile([c["latency_s"] for c in r.calls], q) * 1e3


def phase_ms(r, names) -> float | None:
    """The median, over the traced calls, of the seconds a call spent in
    the named phase spans, in ms; None when no call was traced."""
    per = [sum(c["spans"].get(n, 0.0) for n in names) for c in r.per_call if "spans" in c]
    return statistics.median(per) * 1e3 if per else None


def imbalance(counts) -> float:
    """max/mean of the per-processor counts: the paper's Table II measure
    (1.0 is perfect balance)."""
    c = [int(x) for x in counts]
    mean = sum(c) / len(c)
    return max(c) / mean if mean > 0 else 1.0


def idle_percent(r) -> float | None:
    """The share of the traced stretch in which nothing ran on the card:
    1 - (union of the device intervals) / (the stretch), in %."""
    if r.profile is None or r.busy_s is None or not r.window_traced_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_traced_s)
