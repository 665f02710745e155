"""Bucket-overflow retry policy.

Counterpart of ``repro/core/overflow.py``. The static-capacity exchange
can overflow (detected, never silent: ``sim.SortResult.overflowed``);
the ladder then re-runs the sort with a grown ``capacity_factor``. The
metrics counter and the tuner's measured ladder start are not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


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
