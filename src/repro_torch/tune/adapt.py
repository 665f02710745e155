"""Serve-side feedback controller for `SortServer` flush parameters.

Counterpart of ``repro/tune/adapt.py``, the same arithmetic and metrics.

`max_delay_ms`/`max_batch` trade batching efficiency against tail
latency, and the right point moves with load. The controller closes the
loop against a p99 objective from the live latency window: when p99
overshoots the target it shrinks the flush deadline (then the batch
width once the deadline floors out); when p99 sits comfortably under
target it grows the deadline back to recover coalescing. Three guards
keep it boring in production:

* **hard bounds** — operator-declared min/max for both knobs; the
  controller can only move inside them, never escape them;
* **hysteresis** — a deadband around the target plus a patience count
  (consecutive out-of-band evaluations required) so measurement noise
  cannot make the knobs flap;
* **multiplicative steps** — geometric moves converge in a handful of
  evaluations from anywhere in the bounded range without overshooting
  the way additive steps tuned for one scale do.

The controller is pure arithmetic over numbers the caller feeds it
(`update(p99_ms, completed)`), so `tests/test_torch_tune.py` drives it
against the reference's on the same latency feed.
"""
from __future__ import annotations

import dataclasses

from ..obs import metrics as _metrics

_G_DELAY = _metrics.gauge(
    "repro_tune_serve_max_delay_ms",
    "Current adaptive flush deadline chosen by the tune controller",
)
_G_BATCH = _metrics.gauge(
    "repro_tune_serve_max_batch",
    "Current adaptive flush batch width chosen by the tune controller",
)
_C_ADJUST = _metrics.counter(
    "repro_tune_serve_adjustments_total",
    "Adaptive serve knob adjustments by direction",
    labels=("direction",),
)
_C_SATURATED = _metrics.counter(
    "repro_tune_serve_bound_saturation_total",
    "Adjustment attempts refused because every knob was pinned at the "
    "operator bound in the needed direction — the objective is "
    "unreachable inside the configured bounds",
    labels=("bound",),  # min|max
)


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Objective + hard bounds for :class:`AdaptiveController`.

    The controller never sets ``max_delay_ms`` outside
    [``min_delay_ms``, ``max_delay_ms``] nor ``max_batch`` outside
    [``min_batch``, ``max_batch``] — these are operator limits, not
    hints.
    """

    target_p99_ms: float = 25.0
    min_delay_ms: float = 0.5
    max_delay_ms: float = 50.0
    min_batch: int = 1
    max_batch: int = 64
    # fractional deadband around the target: no moves while
    # p99 in [target*(1-deadband), target*(1+deadband)]
    deadband: float = 0.2
    # multiplicative step per adjustment
    step: float = 1.4
    # consecutive out-of-band evaluations required before moving
    patience: int = 2
    # server-side pacing: seconds between evaluations, and the minimum
    # completed-request count an evaluation window must hold
    interval_s: float = 0.25
    min_samples: int = 8

    def __post_init__(self):
        if self.min_delay_ms <= 0 or self.max_delay_ms < self.min_delay_ms:
            raise ValueError("adapt delay bounds must satisfy "
                             "0 < min_delay_ms <= max_delay_ms")
        if self.min_batch < 1 or self.max_batch < self.min_batch:
            raise ValueError("adapt batch bounds must satisfy "
                             "1 <= min_batch <= max_batch")
        if not (0.0 < self.deadband < 1.0):
            raise ValueError("adapt deadband must be in (0, 1)")
        if self.step <= 1.0:
            raise ValueError("adapt step must be > 1")
        if self.target_p99_ms <= 0:
            raise ValueError("adapt target_p99_ms must be > 0")


class AdaptiveController:
    """Feedback loop over (max_delay_ms, max_batch) against a p99 goal."""

    def __init__(self, config: AdaptConfig = AdaptConfig(),
                 delay_ms: float | None = None, batch: int | None = None):
        self.config = config
        d = config.max_delay_ms if delay_ms is None else float(delay_ms)
        b = config.max_batch if batch is None else int(batch)
        self.delay_ms = min(max(d, config.min_delay_ms), config.max_delay_ms)
        self.batch = min(max(b, config.min_batch), config.max_batch)
        self.adjustments = 0
        # bound-saturation accounting: update() wanted to move but every
        # knob was already pinned at the relevant operator bound. A
        # rising count while p99 stays off-target is the "raise the
        # bounds or add capacity" operator signal; the flight recorder
        # triggers an incident snapshot on it.
        self.bound_saturations = 0
        self.saturated_at: str | None = None  # "min"|"max" while pinned
        self._high = 0
        self._low = 0
        self._publish()

    def _publish(self):
        _G_DELAY.set(self.delay_ms)
        _G_BATCH.set(self.batch)

    def update(self, p99_ms: float, completed: int = 0,
               queue_depth: int = 0) -> bool:
        """Feed one evaluation window; returns True when a knob moved.

        ``p99_ms`` is the tail latency observed over the window,
        ``completed`` its sample count (windows thinner than
        ``min_samples`` are ignored), ``queue_depth`` the current
        backlog (backlog counts as pressure even if the thin sample
        happens to look fast).
        """
        cfg = self.config
        if completed < cfg.min_samples and queue_depth < cfg.min_batch:
            return False
        hi = cfg.target_p99_ms * (1.0 + cfg.deadband)
        lo = cfg.target_p99_ms * (1.0 - cfg.deadband)
        if p99_ms > hi:
            self._high += 1
            self._low = 0
            if self._high >= cfg.patience:
                self._high = 0
                return self._tighten()
        elif p99_ms < lo:
            self._low += 1
            self._high = 0
            if self._low >= cfg.patience:
                self._low = 0
                return self._relax()
        else:
            self._high = self._low = 0
        return False

    def _tighten(self) -> bool:
        """Tail too slow: shrink the flush deadline; once the deadline
        floors out, shrink the batch width too."""
        cfg = self.config
        moved = False
        if self.delay_ms > cfg.min_delay_ms:
            self.delay_ms = max(cfg.min_delay_ms, self.delay_ms / cfg.step)
            moved = True
        elif self.batch > cfg.min_batch:
            self.batch = max(cfg.min_batch, int(self.batch / cfg.step))
            moved = True
        if moved:
            self.adjustments += 1
            self.saturated_at = None
            _C_ADJUST.labels(direction="down").inc()
            self._publish()
        else:
            self.bound_saturations += 1
            self.saturated_at = "min"
            _C_SATURATED.labels(bound="min").inc()
        return moved

    def _relax(self) -> bool:
        """Comfortably under target: recover coalescing — widen the
        batch first (cheap for latency), then the deadline."""
        cfg = self.config
        moved = False
        if self.batch < cfg.max_batch:
            self.batch = min(cfg.max_batch,
                             max(self.batch + 1, int(self.batch * cfg.step)))
            moved = True
        elif self.delay_ms < cfg.max_delay_ms:
            self.delay_ms = min(cfg.max_delay_ms, self.delay_ms * cfg.step)
            moved = True
        if moved:
            self.adjustments += 1
            self.saturated_at = None
            _C_ADJUST.labels(direction="up").inc()
            self._publish()
        else:
            self.bound_saturations += 1
            self.saturated_at = "max"
            _C_SATURATED.labels(bound="max").inc()
        return moved
