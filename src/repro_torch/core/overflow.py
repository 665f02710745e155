"""Bucket-overflow retry policy.

Counterpart of ``repro/core/overflow.py``. The static-capacity exchange
can overflow (detected, never silent: ``sim.SortResult.overflowed``);
the ladder then re-runs the sort with a grown ``capacity_factor``. Every
growth step, in the sim's retries and the stream's per-chunk ladders,
passes through ``retry_overflowed`` and counts on ``LADDER_RETRIES``.
With a tuner ambient, the callers pass ``measured_capacity_need``'s hook,
and the first retry jumps to the capacity the overflowed result's own
``send_counts`` ask for.

On the mesh (``core/sample_sort.py``) every rank runs its own ladder, in
lockstep: the overflow flag is reduced over the axis group before any
rank reads it, and the measured hook reduces the largest bucket over the
group (``group``), so every rank takes the same step at the same time. A
rank that retried alone would wait forever in the next collective.
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
    chunk, or per request of a serving flush) into
    ``(total_ladder_steps, units_that_retried)``."""
    cr = [int(r) for r in chunk_retries]
    return sum(cr), sum(1 for r in cr if r > 0)


def bump_capacity(config, policy: OverflowPolicy):
    return dataclasses.replace(
        config, capacity_factor=config.capacity_factor * policy.growth
    )


def measured_capacity_need(p: int, n_local: int, group=None) -> Callable:
    """The ``measured=`` hook of ``retry_overflowed``: the static bucket
    formula inverted against the overflowed result's own ``send_counts``.

    ``SortConfig.capacity(p, n_local) = min(int(ideal * f) + 32, n_local)``
    with ``ideal = ceil(n_local / p)``, and ``send_counts`` depends only
    on the splitters and the data, not on the capacity, so a re-run's
    traffic is the same and the smallest ``f`` whose buckets hold the
    measured maximum is exactly enough: one retry where blind growth pays
    one per step. Reads the counts once (one host read). ``group``: a mesh
    sort's ``AxisGroup``, whose ranks each hold their own row of the
    counts: the maximum is reduced over it, so every rank asks for the
    same capacity."""

    def need(result, config) -> float | None:
        sc = result.send_counts
        if sc.numel() == 0:
            return None
        max_send = int(sc.max())
        if group is not None:
            (max_send,) = group.all_max([max_send])
        ideal = max(1, -(-int(n_local) // int(p)))
        return max(0.0, (max_send - 31)) / ideal

    return need


def retry_overflowed(run: Callable, config, policy: OverflowPolicy, *, last=None,
                     on_retry: Callable | None = None, measured: Callable | None = None):
    """The attempt at ``config`` already overflowed; walk the ladder.

    ``run(config)`` returns a result with an ``overflowed`` field.
    Returns (result, config_used, retries). Raises ``SortOverflowError``
    when the ladder is exhausted and the policy says to raise.
    ``on_retry(config)`` is called before each re-run. ``measured`` (the
    planner passes it only when a tuner is ambient, so the cold path is
    unchanged): called once with ``(last, config)`` before the first
    retry, it returns the capacity_factor the overflowed result needs (or
    None); when that exceeds the next geometric step, the first retry
    jumps to it, clamped to the ladder's own ceiling
    (``f * growth ** max_doublings``)."""
    result = last
    for i in range(policy.max_doublings):
        target = None
        if i == 0 and measured is not None and result is not None:
            target = measured(result, config)
        stepped = bump_capacity(config, policy)
        if target is not None and target > stepped.capacity_factor:
            ceiling = config.capacity_factor * policy.growth ** policy.max_doublings
            config = dataclasses.replace(config, capacity_factor=min(float(target), ceiling))
        else:
            config = stepped
        LADDER_RETRIES.inc()
        if on_retry is not None:
            on_retry(config)
        result = run(config)
        if not _overflowed(result):
            return result, config, i + 1
    if policy.raise_on_overflow:
        raise SortOverflowError(
            f"sort overflowed even at capacity_factor={config.capacity_factor}"
        )
    return result, config, policy.max_doublings


def run_with_capacity_retry(run: Callable, config, policy: OverflowPolicy = OverflowPolicy(),
                            *, on_retry: Callable | None = None,
                            measured: Callable | None = None):
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
    return retry_overflowed(run, config, policy, last=result, on_retry=on_retry,
                            measured=measured)
