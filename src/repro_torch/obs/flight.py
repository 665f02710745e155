"""repro_torch.obs.flight — always-on flight recorder for the serve tier.

Counterpart of ``repro/obs/flight.py``: the same rings, ids, anomaly
kinds and snapshot JSON (``tests/flight_schema.json`` pins both). dtypes
are recorded by their numpy names (``"float32"``), as ``repro`` records
them.

Aggregated histograms answer "how slow is the service"; they cannot
answer "where did THIS request's 38 ms go" after the fact. This module
keeps the evidence around, cheaply and always:

* **Request contexts** (:class:`RequestContext`): every serve-tier
  request is minted a process-unique ``trace_id`` at submit
  (``SortServer.submit`` / ``SortService.submit``); the context rides
  the pending queue and accumulates the timeline — submit, dispatch,
  resolve — split into queue-wait and execute, plus the linkage to the
  coalesced flush that served it.
* **Flush contexts** (:class:`FlushContext`): every batched flush gets
  a ``flush_id`` and a coarse phase breakdown (stage / sort / d2h) —
  ONE record per program execution, shared by the N member requests,
  linked both ways through the ``trace_id`` list.
* **The recorder** (:class:`FlightRecorder`, process-wide
  :data:`RECORDER`): bounded, thread-safe ring buffers of recent
  request summaries, flush summaries, rate-sampled full phase traces,
  queue-depth history, cost-model predicted-vs-actual pairs, and the
  adaptive controller's knob state. Appends are O(1) dict/deque writes
  under a leaf lock — never file I/O, never a block on the flush loop —
  so it stays on by default under the ``trace_overhead`` <2% gate.
* **Incident snapshots**: on an anomaly trigger (terminal overflow,
  deadline miss, ``QueueFullError`` burst, adaptive controller pinned
  at a bound) the recorder freezes its rings into a structured JSON
  snapshot. Snapshots land in ``$REPRO_FLIGHT_DIR`` when set (one
  ``incident_<kind>_<seq>.json`` per trigger, rate-limited per kind)
  and are always kept on ``RECORDER.incidents`` in memory. The JSON
  shape is a debugging contract pinned by ``tests/flight_schema.json``.

``python -m repro_torch.obsctl`` consumes these snapshots: top-N slow
requests, linked Chrome/Perfetto trace export, metrics diffing.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

from repro_torch.obs import metrics as obs_metrics

SNAPSHOT_SCHEMA = 1

#: the trigger vocabulary — snapshot ``kind`` is always one of these
#: (plus "manual" for operator-requested dumps).
ANOMALY_KINDS = (
    "terminal_overflow",      # a request exhausted the overflow ladder
    "deadline_miss",          # latency > k x max_delay_ms (k: server knob)
    "queue_full_burst",       # QueueFullError rejections clustered in time
    "adapt_bound_saturation", # controller pinned at a bound, still off-target
)

_C_ANOMALIES = obs_metrics.counter(
    "repro_flight_anomalies_total",
    "Flight-recorder anomaly triggers by kind.",
    labels=("kind",),
)
_C_SNAPSHOTS = obs_metrics.counter(
    "repro_flight_snapshots_total",
    "Incident snapshots written to REPRO_FLIGHT_DIR.",
)

# process-unique id mint: pid tag + monotonic counter. next() on an
# itertools.count is atomic under the GIL, so minting needs no lock.
_PID_TAG = f"{os.getpid() & 0xFFFF:04x}"
_IDS = itertools.count(1)


def _dtype_str(dtype) -> str:
    """numpy's name of a numpy or torch dtype."""
    return str(dtype).removeprefix("torch.")


def new_trace_id(prefix: str = "r") -> str:
    """Mint a process-unique id ("r..." requests, "f..." flushes)."""
    return f"{prefix}{_PID_TAG}-{next(_IDS):08x}"


class RequestContext:
    """One request's identity + timeline, minted at submit.

    Timestamps are ``time.monotonic()`` seconds (the serve tier's
    clock); ``summary()`` converts the derived intervals to ms. The
    context is written by exactly one thread at a time (submit thread,
    then flush loop / worker), so it needs no lock of its own.
    """

    __slots__ = ("trace_id", "kind", "n", "dtype", "backend",
                 "t_submit", "t_dispatch", "t_done",
                 "outcome", "error", "flush_id", "coalesced",
                 "retries", "phases", "sampled")

    def __init__(self, t_submit: float, *, trace_id: str | None = None,
                 kind: str = "direct", n: int = 0, dtype=None,
                 backend: str | None = None):
        self.trace_id = trace_id or new_trace_id("r")
        self.kind = kind                # "coalesced" | "direct"
        self.n = int(n)
        self.dtype = None if dtype is None else _dtype_str(dtype)
        self.backend = backend
        self.t_submit = float(t_submit)
        self.t_dispatch: float | None = None
        self.t_done: float | None = None
        self.outcome: str | None = None     # completed|failed|cancelled
        self.error: str | None = None
        self.flush_id: str | None = None    # set by the FlushEngine
        self.coalesced: int | None = None
        self.retries = 0
        self.phases: dict | None = None     # flush/trace phase ms
        self.sampled = False                # full phase trace attached

    def dispatched(self, t: float) -> None:
        self.t_dispatch = float(t)

    def finish(self, outcome: str, t: float | None = None,
               error: Exception | str | None = None) -> None:
        self.t_done = time.monotonic() if t is None else float(t)
        self.outcome = outcome
        if error is not None:
            self.error = repr(error) if isinstance(error, Exception) else str(error)

    @property
    def total_ms(self) -> float | None:
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1e3

    def summary(self) -> dict:
        t_d = self.t_dispatch if self.t_dispatch is not None else self.t_done
        queue_wait = (None if t_d is None
                      else (t_d - self.t_submit) * 1e3)
        execute = (None if (t_d is None or self.t_done is None)
                   else (self.t_done - t_d) * 1e3)
        return {
            "trace_id": self.trace_id,
            "kind": self.kind,
            "n": self.n,
            "dtype": self.dtype,
            "backend": self.backend,
            "outcome": self.outcome,
            "error": self.error,
            "flush_id": self.flush_id,
            "coalesced": self.coalesced,
            "retries": self.retries,
            "t_submit": self.t_submit,
            "t_dispatch": self.t_dispatch,
            "t_done": self.t_done,
            "queue_wait_ms": queue_wait,
            "execute_ms": execute,
            "total_ms": self.total_ms,
            "phases": self.phases,
            "sampled": self.sampled,
        }


class FlushContext:
    """One batched flush execution: identity, members, phases."""

    __slots__ = ("flush_id", "kind", "trace_ids", "batch", "padded_batch",
                 "elems", "dtype", "t0", "phases", "retries", "overflowed")

    def __init__(self, *, kind: str, batch: int, padded_batch: int,
                 elems: int, dtype, trace_ids=None):
        self.flush_id = new_trace_id("f")
        self.kind = kind                # plain|descending|packed
        self.trace_ids = list(trace_ids or [])
        self.batch = int(batch)
        self.padded_batch = int(padded_batch)
        self.elems = int(elems)
        self.dtype = _dtype_str(dtype)
        self.t0 = time.monotonic()
        self.phases: dict[str, float] = {}   # {"stage_ms", "sort_ms", "d2h_ms"}
        self.retries = 0
        self.overflowed = 0

    def summary(self) -> dict:
        return {
            "flush_id": self.flush_id,
            "kind": self.kind,
            "requests": list(self.trace_ids),
            "batch": self.batch,
            "padded_batch": self.padded_batch,
            "elems": self.elems,
            "dtype": self.dtype,
            "t0": self.t0,
            "phases": dict(self.phases),
            "retries": self.retries,
            "overflowed": self.overflowed,
        }


class FlightRecorder:
    """Bounded thread-safe rings + anomaly-triggered incident snapshots.

    All ``record_*`` methods are O(1) appends under one leaf lock (the
    recorder never takes any other lock while holding it, so callers
    may record while holding their own). Snapshot file writes happen in
    ``anomaly()`` only — callers must not invoke it under hot locks.
    """

    def __init__(self, *, capacity: int = 256, flush_capacity: int = 64,
                 trace_capacity: int = 32, depth_capacity: int = 512,
                 prediction_capacity: int = 64, sample_every: int = 16,
                 burst_threshold: int = 8, burst_window_s: float = 1.0,
                 min_dump_interval_s: float = 1.0):
        self._lock = threading.Lock()
        self._requests: deque[dict] = deque(maxlen=capacity)
        self._flushes: deque[dict] = deque(maxlen=flush_capacity)
        self._traces: deque[dict] = deque(maxlen=trace_capacity)
        self._depth: deque[list] = deque(maxlen=depth_capacity)
        self._predictions: deque[dict] = deque(maxlen=prediction_capacity)
        self._adaptive: dict | None = None
        self._slo: dict | None = None
        self._anomalies = {k: 0 for k in ANOMALY_KINDS}
        self._rejects: deque[float] = deque(maxlen=max(2, burst_threshold))
        self._last_dump: dict[str, float] = {}
        self._seq = 0
        self._sample_n = 0
        self.sample_every = int(sample_every)
        self.burst_threshold = int(burst_threshold)
        self.burst_window_s = float(burst_window_s)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.incidents: deque[dict] = deque(maxlen=8)
        self.enabled = True

    # ------------------------------------------------------------- rings
    def record_request(self, summary: dict) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._requests.append(summary)

    def record_flush(self, summary: dict) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._flushes.append(summary)

    def record_trace(self, trace_id: str, spans: list[dict]) -> None:
        """Keep one sampled full phase trace (span name/t0/t1/attrs)."""
        if not self.enabled:
            return
        with self._lock:
            self._traces.append({"trace_id": trace_id, "spans": spans})

    def record_queue_depth(self, depth: int,
                           t: float | None = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._depth.append(
                [time.monotonic() if t is None else float(t), int(depth)])

    def record_prediction(self, op: str, backend: str, n: int,
                          predicted_us: float, actual_us: float) -> None:
        """Cost-model accountability: one predicted-vs-actual pair."""
        if not self.enabled:
            return
        with self._lock:
            self._predictions.append({
                "op": op, "backend": backend, "n": int(n),
                "predicted_us": float(predicted_us),
                "actual_us": float(actual_us),
            })

    def record_adaptive(self, state: dict) -> None:
        """Latest adaptive-controller knob state (overwrites)."""
        if not self.enabled:
            return
        with self._lock:
            self._adaptive = dict(state)

    def record_slo(self, state: dict) -> None:
        """Latest SLO tracker snapshot (overwrites)."""
        if not self.enabled:
            return
        with self._lock:
            self._slo = dict(state)

    def sample(self) -> bool:
        """Rate sampler for full phase traces: every Nth request."""
        if not self.enabled or self.sample_every <= 0:
            return False
        with self._lock:
            self._sample_n += 1
            return self._sample_n % self.sample_every == 1

    def record_rejection(self, t: float | None = None) -> bool:
        """Count one QueueFullError; True when a burst threshold is hit
        (``burst_threshold`` rejections inside ``burst_window_s``)."""
        if not self.enabled:
            return False
        now = time.monotonic() if t is None else float(t)
        with self._lock:
            self._rejects.append(now)
            return (len(self._rejects) == self._rejects.maxlen
                    and now - self._rejects[0] <= self.burst_window_s)

    # --------------------------------------------------------- snapshots
    def snapshot(self, kind: str = "manual", detail: dict | None = None) -> dict:
        """Freeze the rings into one structured, JSON-serializable dict.
        Shape is pinned by ``tests/flight_schema.json``."""
        with self._lock:
            self._seq += 1
            return {
                "schema": SNAPSHOT_SCHEMA,
                "kind": kind,
                "detail": dict(detail or {}),
                "seq": self._seq,
                "ts_unix": time.time(),
                "ts_monotonic": time.monotonic(),
                "requests": list(self._requests),
                "flushes": list(self._flushes),
                "traces": list(self._traces),
                "queue_depth": list(self._depth),
                "predictions": list(self._predictions),
                "adaptive": self._adaptive,
                "slo": self._slo,
                "anomaly_counts": dict(self._anomalies),
            }

    def anomaly(self, kind: str, detail: dict | None = None, *,
                flight_dir: str | None = None) -> str | None:
        """Trigger one anomaly: count it, snapshot the rings, and write
        ``incident_<kind>_<seq>.json`` into ``flight_dir`` (default
        ``$REPRO_FLIGHT_DIR``; kept in-memory only when unset). Dumps
        are rate-limited per kind so an anomaly storm cannot flood the
        disk. Returns the written path, or None."""
        if not self.enabled:
            return None
        if kind not in ANOMALY_KINDS:
            raise KeyError(f"unknown anomaly kind {kind!r}; "
                           f"have {ANOMALY_KINDS}")
        with self._lock:
            self._anomalies[kind] += 1
        _C_ANOMALIES.labels(kind=kind).inc()
        snap = self.snapshot(kind, detail)
        self.incidents.append(snap)
        out_dir = flight_dir if flight_dir is not None else os.environ.get(
            "REPRO_FLIGHT_DIR", "")
        if not out_dir:
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(kind)
            if last is not None and now - last < self.min_dump_interval_s:
                return None
            self._last_dump[kind] = now
        path = os.path.join(out_dir, f"incident_{kind}_{snap['seq']:05d}.json")
        try:
            os.makedirs(out_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(snap, f, indent=1)
        except OSError:
            return None  # a broken dump dir must never fail a request
        _C_SNAPSHOTS.inc()
        return path

    def reset(self) -> None:
        """Drop all recorded state (tests / between benchmark phases)."""
        with self._lock:
            self._requests.clear()
            self._flushes.clear()
            self._traces.clear()
            self._depth.clear()
            self._predictions.clear()
            self._rejects.clear()
            self._adaptive = None
            self._slo = None
            self._anomalies = {k: 0 for k in ANOMALY_KINDS}
            self._last_dump.clear()
            self._sample_n = 0
        self.incidents.clear()


#: the process-wide recorder every serve-tier component records into —
#: the flight analogue of ``obs.metrics.REGISTRY``.
RECORDER = FlightRecorder()


def set_enabled(flag: bool) -> None:
    """Kill switch wired into ``obs.set_enabled`` / ``obs.disabled()``."""
    RECORDER.enabled = bool(flag)
