"""repro_torch.obs.slo — declarative latency / error-budget objectives.

Counterpart of ``repro/obs/slo.py``, the same arithmetic and gauges.

An SLO here is the operator's contract in numbers: "``error_budget`` of
requests may be slower than ``threshold_ms`` (or fail) over the rolling
``window``". The tracker turns every request completion into three
scrapeable signals:

* ``repro_slo_requests_total{slo,verdict}`` — ok/breach counts;
* ``repro_slo_violation_ratio{slo}`` — breaching fraction of the window;
* ``repro_slo_burn_rate{slo}`` — violation_ratio / error_budget. The
  alerting quantity: 1.0 means the budget is being consumed exactly as
  provisioned; >1 means it will be exhausted before the window turns
  over (page at sustained 2-10x, the standard multi-window burn alert).

``SortServer(slo=...)`` feeds its end-to-end latencies in; when the
server is adaptive and no explicit SLO is given, the objective derives
from the SAME ``AdaptConfig.target_p99_ms`` the controller steers on
(``SLOConfig.from_adapt``) — one number, two consumers: the controller
moves the knobs toward it, the SLO reports whether that sufficed.
``stats()["slo"]`` exposes the live snapshot, and the flight recorder
embeds it in incident snapshots.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque

from repro_torch.obs import metrics as obs_metrics

_C_REQUESTS = obs_metrics.counter(
    "repro_slo_requests_total",
    "Requests judged against an SLO, by verdict.",
    labels=("slo", "verdict"),  # ok|breach
)
_G_RATIO = obs_metrics.gauge(
    "repro_slo_violation_ratio",
    "Breaching fraction of the SLO's rolling window.",
    labels=("slo",),
)
_G_BURN = obs_metrics.gauge(
    "repro_slo_burn_rate",
    "Error-budget burn rate (violation_ratio / error_budget).",
    labels=("slo",),
)


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """One latency objective: at most ``error_budget`` of the rolling
    ``window`` requests may exceed ``threshold_ms`` or fail."""

    name: str = "serve_latency"
    threshold_ms: float = 25.0
    error_budget: float = 0.01
    window: int = 2048

    def __post_init__(self):
        if self.threshold_ms <= 0:
            raise ValueError("slo threshold_ms must be > 0")
        if not (0.0 < self.error_budget < 1.0):
            raise ValueError("slo error_budget must be in (0, 1)")
        if self.window < 1:
            raise ValueError("slo window must be >= 1")

    @classmethod
    def from_adapt(cls, adapt_config) -> "SLOConfig":
        """Derive the objective from the adaptive controller's p99
        target: by construction a p99 objective tolerates 1% slow."""
        return cls(name="serve_p99",
                   threshold_ms=float(adapt_config.target_p99_ms),
                   error_budget=0.01)


class SLOTracker:
    """Rolling-window judge for one :class:`SLOConfig`.

    ``observe()`` is O(1) under a leaf lock (an int update plus three
    gauge sets), cheap enough for every request completion.
    """

    def __init__(self, config: SLOConfig = SLOConfig()):
        self.config = config
        self._lock = threading.Lock()
        self._ring: deque[bool] = deque(maxlen=config.window)  # True = breach
        self._bad_in_window = 0
        self.observed = 0
        self.breaches = 0
        # surface the family immediately: a healthy service scrapes 0.0,
        # not an absent series
        _G_RATIO.labels(slo=config.name).set(0.0)
        _G_BURN.labels(slo=config.name).set(0.0)

    def observe(self, latency_ms: float | None, error: bool = False) -> bool:
        """Judge one completed request; returns True when it breached."""
        cfg = self.config
        bad = bool(error) or (latency_ms is None
                              or latency_ms > cfg.threshold_ms)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._bad_in_window -= self._ring[0]
            self._ring.append(bad)
            self._bad_in_window += bad
            self.observed += 1
            self.breaches += bad
            ratio = self._bad_in_window / len(self._ring)
        _C_REQUESTS.labels(slo=cfg.name,
                           verdict="breach" if bad else "ok").inc()
        _G_RATIO.labels(slo=cfg.name).set(ratio)
        _G_BURN.labels(slo=cfg.name).set(ratio / cfg.error_budget)
        return bad

    @property
    def violation_ratio(self) -> float:
        with self._lock:
            return self._bad_in_window / len(self._ring) if self._ring else 0.0

    @property
    def burn_rate(self) -> float:
        return self.violation_ratio / self.config.error_budget

    def snapshot(self) -> dict:
        """The ``stats()`` / flight-recorder view of this objective."""
        with self._lock:
            n = len(self._ring)
            ratio = self._bad_in_window / n if n else 0.0
            observed, breaches = self.observed, self.breaches
        cfg = self.config
        return {
            "name": cfg.name,
            "threshold_ms": cfg.threshold_ms,
            "error_budget": cfg.error_budget,
            "window": cfg.window,
            "observed": observed,
            "breaches": breaches,
            "violation_ratio": ratio,
            "burn_rate": ratio / cfg.error_budget,
            "budget_remaining": max(0.0, 1.0 - ratio / cfg.error_budget),
        }
