"""Bucket-overflow retry policy.

Counterpart of ``repro/core/overflow.py``. The static-capacity exchange
can overflow (detected, never silent: ``sim.SortResult.overflowed``);
the ladder then re-runs the sort with a grown ``capacity_factor``. Every
growth step, in the sim's retries and the stream's per-chunk ladders,
passes through ``retry_overflowed`` and counts on ``LADDER_RETRIES``. The
tuner's measured ladder start (``measured_capacity_need``) is not ported
yet (ROADMAP.md §1, item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.obs import metrics as _obs_metrics

LADDER_RETRIES = _obs_metrics.counter(
    "repro_overflow_ladder_retries_total",
    "Capacity-ladder growth steps taken after static-bucket overflow.",
)


class SortOverflowError(RuntimeError):
    """The sort still overflowed after exhausting the capacity ladder."""


@dataclasses.dataclass(frozen=True)
class OverflowPolicy:
    """Capacity-growth ladder applied when static buckets overflow.

    max_doublings: growth steps before giving up (0 = never retry).
    growth: capacity_factor multiplier per step.
    raise_on_overflow: False returns the overflowed result instead of
      raising.
    """

    max_doublings: int = 3
    growth: float = 2.0
    raise_on_overflow: bool = True


def _overflowed(result) -> bool:
    return bool(result.overflowed)


def ladder_totals(chunk_retries) -> tuple[int, int]:
    """Aggregate per-chunk ladder steps (one entry per stream pass-1
    chunk) into ``(total_ladder_steps, chunks_that_retried)``."""
    cr = [int(r) for r in chunk_retries]
    return sum(cr), sum(1 for r in cr if r > 0)


def bump_capacity(config, policy: OverflowPolicy):
    return dataclasses.replace(
        config, capacity_factor=config.capacity_factor * policy.growth
    )


def retry_overflowed(run: Callable, config, policy: OverflowPolicy, *, last=None):
    """The attempt at ``config`` already overflowed; walk the ladder.

    ``run(config)`` returns a result with an ``overflowed`` field.
    Returns (result, config_used, retries). Raises ``SortOverflowError``
    when the ladder is exhausted and the policy says to raise."""
    result = last
    for i in range(policy.max_doublings):
        config = bump_capacity(config, policy)
        LADDER_RETRIES.inc()
        result = run(config)
        if not _overflowed(result):
            return result, config, i + 1
    if policy.raise_on_overflow:
        raise SortOverflowError(
            f"sort overflowed even at capacity_factor={config.capacity_factor}"
        )
    return result, config, policy.max_doublings


def run_with_capacity_retry(run: Callable, config,
                            policy: OverflowPolicy = OverflowPolicy()):
    """Initial attempt + capacity ladder. Returns (result, config, retries)."""
    result = run(config)
    if not _overflowed(result):
        return result, config, 0
    if policy.max_doublings == 0:
        if policy.raise_on_overflow:
            raise SortOverflowError(
                f"sort overflowed even at capacity_factor={config.capacity_factor}"
            )
        return result, config, 0
    return retry_overflowed(run, config, policy, last=result)
