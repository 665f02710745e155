"""Phase-level wall-time spans for the sort pipeline.

Counterpart of ``repro/obs/tracing.py``: one ``Span`` per pipeline phase
(plan, encode, stage, local sort, splitter, exchange, merge, decode, d2h;
the stream's three passes as local_sort, splitter and one merge per
bucket) with per-processor element counts and the measured imbalance
attached where a phase has a processor axis.

A ``Trace`` is created either explicitly::

    with obs.trace() as tr:
        out = repro_torch.sort(x)
        out.keys  # materialize
    tr.to_chrome_file("sort.trace.json")

or implicitly via ``SortLimits(trace=True)``, in which case the planner
builds one and attaches it as ``SortOutput.meta.trace``. Spans are flat
and appended under a lock; ``coverage()`` reports the fraction of the
trace's wall window covered by at least one span.

Once the owning ``SortOutput`` materializes, the trace is frozen: its
spans are published to the metrics registry
(``repro_sort_phase_seconds{backend,phase}``) and further ``span()``
calls raise. Ambient traces (``obs.trace()``) stay open across several
sorts and freeze when the context exits.

CUDA work is asynchronous, so a span that should account for device work
fences: ``sp.fence(value)`` waits for the devices of the CUDA tensors in
``value`` (``torch.cuda.synchronize``) inside the span. It does nothing
for CPU tensors, and the no-op span of an untraced call never waits: only
a traced sort synchronises for its spans.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Iterator

import torch

from repro_torch.obs import metrics as _metrics

_state = threading.local()

_enabled = True

# per-phase wall time, published at trace freeze
_PHASE_SECONDS = _metrics.histogram(
    "repro_sort_phase_seconds",
    "Wall time per sort pipeline phase.",
    labels=("backend", "phase"),
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
             2.5, 5.0, 10.0, 30.0, float("inf")),
)


def set_enabled(flag: bool) -> None:
    """Kill switch: while disabled, ``current_trace()`` returns None and
    ``maybe_span`` yields the no-op handle."""
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors in ``value`` (tensors, and tuples,
    lists and NamedTuples of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    return out


class Span:
    """One closed phase interval. ``t0``/``t1`` are perf_counter seconds;
    ``attrs`` carries phase payload (per_proc counts, imbalance, retries,
    ...)."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float, attrs: dict):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Span({self.name!r}, {self.duration * 1e3:.3f}ms, {self.attrs})"


class _OpenSpan:
    """Handle yielded by ``Trace.span`` while the interval is open."""

    __slots__ = ("_trace", "name", "attrs")

    def __init__(self, trace: "Trace", name: str):
        self._trace = trace
        self.name = name
        self.attrs: dict[str, Any] = {}

    def set(self, **kv) -> "_OpenSpan":
        self.attrs.update(kv)
        return self

    def counts(self, per_proc) -> "_OpenSpan":
        """Attach per-processor element counts (a sequence, a numpy array
        or a tensor, read in one copy); derives the paper's imbalance metric
        (max/mean) for this phase."""
        c = [int(x) for x in (per_proc.tolist() if hasattr(per_proc, "tolist") else per_proc)]
        self.attrs["per_proc"] = c
        mean = sum(c) / len(c) if c else 0.0
        self.attrs["imbalance"] = (max(c) / mean) if mean > 0 else 1.0
        return self

    def fence(self, value) -> Any:
        """Wait, inside the span, until the devices of ``value``'s CUDA
        tensors finish their queued work, so the phase is charged its
        device time. CPU tensors need no wait."""
        for dev in _cuda_devices(value, set()):
            torch.cuda.synchronize(dev)
        return value


class Trace:
    """An append-only, lockable collection of phase spans.

    ``labels`` (notably ``backend``) flow into the registry histogram at
    freeze time and into the Chrome export's process name.
    """

    def __init__(self, labels: dict | None = None, *, ambient: bool = False):
        self.labels = dict(labels or {})
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._frozen = False
        self._published = 0  # spans[:_published] already sent to registry
        self._ambient = ambient

    def span(self, name: str, **attrs) -> "_SpanContext":
        """A context manager timing one phase from entry to exit; it
        yields the open span's handle."""
        if self._frozen:
            raise RuntimeError(
                f"trace is frozen (materialized); cannot open span {name!r}"
            )
        return _SpanContext(self, name, attrs)

    # ---- derived views -------------------------------------------------

    def duration(self) -> float:
        """Wall window spanned by the trace: max end - min start."""
        with self._lock:
            if not self.spans:
                return 0.0
            return max(s.t1 for s in self.spans) - min(s.t0 for s in self.spans)

    def coverage(self) -> float:
        """Fraction of the wall window covered by >= 1 span (union of
        intervals / window)."""
        with self._lock:
            ivals = sorted((s.t0, s.t1) for s in self.spans)
        if not ivals:
            return 0.0
        lo = ivals[0][0]
        hi = max(t1 for _, t1 in ivals)
        window = hi - lo
        if window <= 0:
            return 1.0
        covered = 0.0
        cur_lo, cur_hi = ivals[0]
        for t0, t1 in ivals[1:]:
            if t0 > cur_hi:
                covered += cur_hi - cur_lo
                cur_lo, cur_hi = t0, t1
            else:
                cur_hi = max(cur_hi, t1)
        covered += cur_hi - cur_lo
        return covered / window

    def phase_totals(self) -> dict[str, float]:
        """Summed seconds per phase name, in first-seen order."""
        out: dict[str, float] = {}
        with self._lock:
            for s in self.spans:
                out[s.name] = out.get(s.name, 0.0) + s.duration
        return out

    # ---- lifecycle -----------------------------------------------------

    def _publish_locked(self) -> None:
        backend = str(self.labels.get("backend", "unknown"))
        for s in self.spans[self._published:]:
            _PHASE_SECONDS.labels(backend=backend, phase=s.name).observe(s.duration)
        self._published = len(self.spans)

    def freeze(self) -> "Trace":
        """Publish unpublished spans to the registry and make the trace
        immutable. Idempotent."""
        with self._lock:
            self._publish_locked()
            self._frozen = True
        return self

    @property
    def frozen(self) -> bool:
        return self._frozen

    def materialized(self) -> None:
        """Called when the owning ``SortOutput`` materializes. A per-sort
        trace freezes here; an ambient trace only publishes (it may span
        several sorts and freezes when its context exits)."""
        if self._ambient:
            with self._lock:
                self._publish_locked()
        else:
            self.freeze()

    # ---- export --------------------------------------------------------

    def to_chrome(self) -> list[dict]:
        """Chrome/Perfetto trace-event JSON objects (``ph: "X"`` complete
        events, microsecond timestamps relative to the trace start)."""
        with self._lock:
            spans = list(self.spans)
        if not spans:
            return []
        t_base = min(s.t0 for s in spans)
        name = ",".join(f"{k}={v}" for k, v in sorted(self.labels.items()))
        events: list[dict] = [{
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "args": {"name": f"repro_torch.sort({name})" if name else "repro_torch.sort"},
        }]
        for s in spans:
            events.append({
                "name": s.name,
                "ph": "X",
                "pid": 1,
                "tid": 1,
                "ts": round((s.t0 - t_base) * 1e6, 3),
                "dur": round(s.duration * 1e6, 3),
                "args": dict(s.attrs),
            })
        return events

    def to_chrome_file(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.to_chrome()}, f)
        return path


class _SpanContext:
    """``Trace.span``'s context manager: a class, not a generator, so that
    little host time falls between one phase's span and the next."""

    __slots__ = ("_trace", "_span", "_t0")

    def __init__(self, trace: Trace, name: str, attrs: dict):
        self._trace = trace
        self._span = _OpenSpan(trace, name)
        self._span.attrs.update(attrs)

    def __enter__(self) -> _OpenSpan:
        self._t0 = time.perf_counter()
        return self._span

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        tr = self._trace
        with tr._lock:
            if not tr._frozen:
                tr.spans.append(Span(self._span.name, self._t0, t1, self._span.attrs))
        return False


class _NullSpan:
    """No-op span handle so instrumentation sites can be unconditional:
    it records nothing, reads nothing and waits for nothing."""

    __slots__ = ()

    def set(self, **kv):
        return self

    def counts(self, per_proc):
        return self

    def fence(self, value):
        return value


_NULL_SPAN = _NullSpan()


class _NullContext:
    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NULL_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_NULL_CONTEXT = _NullContext()


def maybe_span(trace: "Trace | None", name: str, **attrs):
    """``trace.span(...)`` when a trace is active, a no-op context yielding
    the no-op handle when not. A frozen trace also degrades to the no-op
    handle: late materialization (``.keys`` read after an ambient block
    exited) goes unattributed instead of raising."""
    if trace is None or not _enabled or trace.frozen:
        return _NULL_CONTEXT
    return trace.span(name, **attrs)


def current_trace() -> Trace | None:
    """The thread's ambient trace, or None (also None while disabled)."""
    if not _enabled:
        return None
    return getattr(_state, "trace", None)


@contextlib.contextmanager
def trace(labels: dict | None = None, **labelkw) -> Iterator[Trace]:
    """Install an ambient trace for the current thread. Every
    ``repro_torch.sort`` issued inside the block records its phases here;
    the trace freezes when the block exits."""
    tr = Trace({**(labels or {}), **labelkw}, ambient=True)
    prev = getattr(_state, "trace", None)
    _state.trace = tr
    try:
        yield tr
    finally:
        _state.trace = prev
        tr.freeze()
