"""Rates over the whole window, percentiles over every request, the
spread that sets a bound, and idle as a union of intervals."""
import math
import statistics

import benchkit  # noqa: F401
import pytest

from benchlib import readings, stats
from benchlib.harness import Reading


def _load(name):
    from benchlib import registry

    return registry.reader(name)


def test_percentile_is_nearest_rank_over_every_value():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95 and stats.percentile(v, 90) == 90
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.beyond(v, 95) == 5
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_a_failed_request_misses_every_limit():
    v = [0.1] * 19 + [math.inf]
    assert stats.percentile(v, 95) == 0.1
    assert stats.percentile(v + [math.inf], 95) == math.inf


def test_tails_are_over_all_requests_not_medians_of_chunks():
    calls = [{"latency_s": 0.1, "items": 1, "ok": True}] * 180 + \
            [{"latency_s": 0.5, "items": 1, "ok": True}] * 20
    r = Reading(calls=calls, window_s=10.0)
    assert _load("sort_p95_ms")(r) == pytest.approx(500.0)
    assert _load("ttft_p90_ms")(r) == pytest.approx(100.0)


def test_rates_are_over_the_whole_window():
    calls = [{"latency_s": 0.2, "items": 1 << 27, "ok": True}] * 50 + \
            [{"latency_s": math.inf, "items": 1 << 27, "ok": False}]
    r = Reading(calls=calls, window_s=12.5)
    assert _load("sort_keys_per_s")(r) == pytest.approx(50 * (1 << 27) / 12.5)
    assert _load("prefill_tokens_per_s")(r) == pytest.approx(50 * (1 << 27) / 12.5)
    assert r.attempted == 51 and r.failed == 1


def test_spread_is_python_quartiles_over_the_median():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_union_counts_overlaps_once():
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert stats.union_length([]) == 0
    assert stats.gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [(0, 1), (3, 4), (5, 6)]


def test_idle_share_from_the_union():
    class P:
        pass

    r = Reading(busy_s=0.75, window_traced_s=1.0)
    r.profile = P()
    assert readings.idle_percent(r) == pytest.approx(25.0)
    assert readings.idle_percent(Reading()) is None


def test_imbalance_is_max_over_mean():
    assert readings.imbalance([10, 10, 10, 10]) == 1.0
    assert readings.imbalance([5, 15]) == pytest.approx(1.5)


def test_reservoir_sample_depends_on_the_seed_alone():
    def draw(seed):
        s = stats.Reservoir(3, seed)
        for i in range(100):
            s.offer(lambda i=i: i)
        return s.items

    assert draw(7) == draw(7) and draw(7) != draw(8)
    assert len(set(draw(9))) == 3
