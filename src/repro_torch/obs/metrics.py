"""Dependency-free metrics registry with Prometheus text exposition.

Counterpart of ``repro/obs/metrics.py`` (a copy: the port imports nothing
of ``repro``). One process-wide ``REGISTRY`` is the port's telemetry sink:
the planner's per-backend sort counter, the overflow ladder's retry
counter and the trace's per-phase histogram publish here, under
``repro``'s metric names and labels (``tests/metrics_schema.json``).
Counters, gauges and histograms are plain dicts under a lock, and the
renderer emits the Prometheus text exposition format directly.

Registration is idempotent: asking for an existing metric name returns
the existing metric (label names and kind must match; a mismatch raises).

``set_enabled(False)`` (or ``repro_torch.obs.disabled()``) turns every
mutation into a no-op.
"""
from __future__ import annotations

import math
import threading

_lock = threading.Lock()
_enabled = True


def set_enabled(flag: bool) -> None:
    """Globally enable/disable metric mutation (rendering still works)."""
    global _enabled
    _enabled = bool(flag)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _fmt_le(v: float) -> str:
    return "+Inf" if v == math.inf else _fmt_value(v)


DEFAULT_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 10000.0, math.inf,
)


class Metric:
    """One metric family: a kind, a name, label names, and per-labelset
    children. Unlabeled metrics mutate through the family object itself
    (``inc``/``set``/``observe`` proxy to the ``()`` child)."""

    def __init__(self, kind: str, name: str, help_: str,
                 labelnames: tuple, buckets: tuple | None = None):
        self.kind = kind
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets is not None else None
        self._children: dict[tuple, "_Child"] = {}

    def labels(self, **kv) -> "_Child":
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(kv)}"
            )
        values = tuple(str(kv[k]) for k in self.labelnames)
        with _lock:
            child = self._children.get(values)
            if child is None:
                child = _Child(self, values)
                self._children[values] = child
        return child

    def _default(self) -> "_Child":
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.labelnames}; "
                f"use .labels(...)"
            )
        with _lock:
            child = self._children.get(())
            if child is None:
                child = _Child(self, ())
                self._children[()] = child
        return child

    # unlabeled convenience surface
    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    @property
    def value(self) -> float:
        return self._default().value


class _Child:
    """One labeled time series of a metric family."""

    __slots__ = ("_metric", "_labelvalues", "value", "_bucket_counts",
                 "_sum", "_count")

    def __init__(self, metric: Metric, labelvalues: tuple):
        self._metric = metric
        self._labelvalues = labelvalues
        self.value = 0.0
        if metric.kind == "histogram":
            self._bucket_counts = [0] * len(metric.buckets)
            self._sum = 0.0
            self._count = 0

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        if self._metric.kind != "counter":
            raise TypeError(f"{self._metric.name} is a {self._metric.kind}")
        if amount < 0:
            raise ValueError("counters only go up")
        with _lock:
            self.value += amount

    def set(self, value: float) -> None:
        if not _enabled:
            return
        if self._metric.kind != "gauge":
            raise TypeError(f"{self._metric.name} is a {self._metric.kind}")
        with _lock:
            self.value = float(value)

    def observe(self, value: float) -> None:
        if not _enabled:
            return
        if self._metric.kind != "histogram":
            raise TypeError(f"{self._metric.name} is a {self._metric.kind}")
        v = float(value)
        with _lock:
            for i, b in enumerate(self._metric.buckets):
                if v <= b:
                    self._bucket_counts[i] += 1
            self._sum += v
            self._count += 1


class MetricsRegistry:
    """Named metric families; idempotent registration; text renderer."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _register(self, kind: str, name: str, help_: str, labels: tuple,
                  buckets: tuple | None = None) -> Metric:
        with _lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}"
                        f"{m.labelnames}; asked for {kind}{tuple(labels)}"
                    )
                return m
            m = Metric(kind, name, help_, tuple(labels), buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_: str = "", labels: tuple = ()) -> Metric:
        return self._register("counter", name, help_, labels)

    def gauge(self, name: str, help_: str = "", labels: tuple = ()) -> Metric:
        return self._register("gauge", name, help_, labels)

    def histogram(self, name: str, help_: str = "", labels: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS) -> Metric:
        b = tuple(sorted(set(float(x) for x in buckets) | {math.inf}))
        return self._register("histogram", name, help_, labels, b)

    def describe(self) -> list[dict]:
        """Stable schema view: name, kind, label names per family — what
        the CI metric-name stability check diffs against its checked-in
        schema file (``tests/metrics_schema.json``)."""
        with _lock:
            fams = list(self._metrics.values())
        return sorted(
            ({"name": m.name, "type": m.kind, "labels": sorted(m.labelnames)}
             for m in fams),
            key=lambda d: d["name"],
        )

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every family."""
        lines: list[str] = []
        with _lock:
            fams = sorted(self._metrics.values(), key=lambda m: m.name)
            for m in fams:
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                children = sorted(m._children.items())
                if not children and m.kind != "histogram":
                    # an unlabeled family renders its zero sample so the
                    # scrape surface is stable before first mutation
                    if not m.labelnames:
                        lines.append(f"{m.name} 0")
                    continue
                for values, child in children:
                    pairs = ",".join(
                        f'{k}="{_escape_label(v)}"'
                        for k, v in zip(m.labelnames, values)
                    )
                    if m.kind == "histogram":
                        # _bucket_counts are already cumulative (observe
                        # increments every bucket with le >= v)
                        for b, c in zip(m.buckets, child._bucket_counts):
                            sep = "," if pairs else ""
                            lines.append(
                                f'{m.name}_bucket{{{pairs}{sep}le='
                                f'"{_fmt_le(b)}"}} {c}'
                            )
                        suffix = f"{{{pairs}}}" if pairs else ""
                        lines.append(
                            f"{m.name}_sum{suffix} {_fmt_value(child._sum)}"
                        )
                        lines.append(f"{m.name}_count{suffix} {child._count}")
                    else:
                        suffix = f"{{{pairs}}}" if pairs else ""
                        lines.append(
                            f"{m.name}{suffix} {_fmt_value(child.value)}"
                        )
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()


def counter(name: str, help_: str = "", labels: tuple = ()) -> Metric:
    return REGISTRY.counter(name, help_, labels)


def gauge(name: str, help_: str = "", labels: tuple = ()) -> Metric:
    return REGISTRY.gauge(name, help_, labels)


def histogram(name: str, help_: str = "", labels: tuple = (),
              buckets: tuple = DEFAULT_BUCKETS) -> Metric:
    return REGISTRY.histogram(name, help_, labels, buckets)


def render_prometheus(registry: MetricsRegistry | None = None) -> str:
    return (registry or REGISTRY).render()
