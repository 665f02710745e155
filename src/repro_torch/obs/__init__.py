"""repro_torch.obs: tracing, metrics and profiler ranges for the sort.

Counterpart of ``repro.obs``, without the serve tier's flight recorder and
SLOs (ROADMAP.md §1, item 8):

* **Spans** (``obs.trace()`` / ``SortLimits(trace=True)``): wall-time
  phase breakdown of a sort with per-processor counts and measured
  imbalance, exportable as Chrome trace-event JSON. See ``tracing``.
* **Metrics** (``obs.counter/gauge/histogram``, ``obs.render_prometheus``):
  the port's process-wide registry, under ``repro``'s metric names. See
  ``metrics``.
* **Profiling** (``obs.annotate``): ``torch.profiler.record_function``
  ranges on the stream's staging (``REPRO_PROFILE=1``).

``obs.disabled()`` switches spans and metric mutation off for a block.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs import metrics, profiling, tracing
from repro_torch.obs.metrics import (
    REGISTRY,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    render_prometheus,
)
from repro_torch.obs.profiling import annotate, set_profiling
from repro_torch.obs.tracing import Span, Trace, current_trace, maybe_span, trace

__all__ = [
    "metrics",
    "profiling",
    "tracing",
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
    """Master switch for spans and metric mutation."""
    tracing.set_enabled(flag)
    metrics.set_enabled(flag)


@contextlib.contextmanager
def disabled():
    """Run a block with all observability off (spans skipped, metric
    mutations dropped). Not reentrancy-counted."""
    set_enabled(False)
    try:
        yield
    finally:
        set_enabled(True)
