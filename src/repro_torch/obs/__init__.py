"""repro_torch.obs: tracing, metrics and profiler ranges for the sort.

Counterpart of ``repro.obs``:

* **Spans** (``obs.trace()`` / ``SortLimits(trace=True)``): wall-time
  phase breakdown of a sort with per-processor counts and measured
  imbalance, exportable as Chrome trace-event JSON. See ``tracing``.
* **Metrics** (``obs.counter/gauge/histogram``, ``obs.render_prometheus``):
  the port's process-wide registry, under ``repro``'s metric names. See
  ``metrics``.
* **Profiling** (``obs.annotate``): ``torch.profiler.record_function``
  ranges on the stream's staging and the serve tier's flushes
  (``REPRO_PROFILE=1``).
* **Flight recorder** (``obs.flight``): always-on bounded rings of
  recent request/flush summaries with per-request ``trace_id``s, dumped
  as incident snapshots to ``$REPRO_FLIGHT_DIR`` on anomaly triggers.
  See ``python -m repro_torch.obsctl``.
* **SLOs** (``obs.slo``): latency / error-budget objectives with
  burn-rate gauges in the registry (``SortServer(slo=...)``).

``obs.disabled()`` switches spans, metric mutation and flight recording
off for a block.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs import flight, metrics, profiling, slo, tracing
from repro_torch.obs.flight import RECORDER, FlightRecorder, new_trace_id
from repro_torch.obs.metrics import (
    REGISTRY,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    render_prometheus,
)
from repro_torch.obs.profiling import annotate, set_profiling
from repro_torch.obs.slo import SLOConfig, SLOTracker
from repro_torch.obs.tracing import Span, Trace, current_trace, maybe_span, trace

__all__ = [
    "metrics",
    "profiling",
    "tracing",
    "flight",
    "slo",
    "RECORDER",
    "FlightRecorder",
    "new_trace_id",
    "SLOConfig",
    "SLOTracker",
    "REGISTRY",
    "MetricsRegistry",
    "counter",
    "gauge",
    "histogram",
    "render_prometheus",
    "annotate",
    "set_profiling",
    "Span",
    "Trace",
    "current_trace",
    "maybe_span",
    "trace",
    "disabled",
    "set_enabled",
]


def set_enabled(flag: bool) -> None:
    """Master switch for spans, metric mutation and flight recording."""
    tracing.set_enabled(flag)
    metrics.set_enabled(flag)
    flight.set_enabled(flag)


@contextlib.contextmanager
def disabled():
    """Run a block with all observability off (spans skipped, metric
    mutations dropped). Not reentrancy-counted."""
    set_enabled(False)
    try:
        yield
    finally:
        set_enabled(True)
