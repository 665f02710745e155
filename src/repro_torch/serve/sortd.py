"""repro_torch.serve.sortd: asynchronous, latency-targeted sort serving.

Counterpart of ``repro/serve/sortd.py``, the "let the process continue
without waiting" front end for sort traffic:

* ``SortServer.submit(keys, values=None, **sort_kwargs)`` returns a
  ``SortFuture`` at once; a background flush loop coalesces
  same-shape-bucket requests and fires a batch when ``max_batch``
  requests share a bucket or the oldest has waited ``max_delay_ms``.
* Dispatch is planner-driven: every request is planned at admission
  (``core.planner.serve_profile``). Keys-only requests that the planner
  routes to the sim backend (single-key, ascending or descending, and
  packed multi-key tuples; declare ``SortLimits.key_bits`` for served
  tuples, so that the pack spec, and so the bucket, stays stable) run in
  ONE batched flush per (shape, order, width, packspec) bucket
  (``stream.service.FlushEngine``, shared with the sync service): the
  batch folds into the kernels' rows, so a flush of B requests launches
  each bitonic kernel as often as one sort. Everything else (payloads,
  argsorts, LSD tuples, streamed requests) runs alone through
  ``core.planner.execute_request`` on a small worker pool, so a
  seconds-long out-of-core sort cannot hold the flush loop's deadlines.
* Overload degrades predictably: the pending queue is bounded
  (``QueueFullError`` with a ``retry_after_ms`` hint), requests above
  ``SortLimits.max_request_elems`` are refused (``RequestTooLargeError``);
  with an ambient ``repro_torch.tune`` tuner the hint is the model's
  predicted drain time, and ``max_queue_cost_us`` adds cost-based
  admission.
* Tenants: ``submit(..., tenant=..., priority=...)``; dispatch order is
  start-time weighted fair queuing over ``(priority, virtual finish tag,
  arrival)``, so a flooding tenant owns at most its weighted share of a
  flush.
* ``submit_topk`` / ``submit_searchsorted`` / ``submit_percentile`` plan
  as keys-only sorts (they coalesce with plain traffic) and answer with
  ``core.topk``'s views of the sorted keys; ``submit(...,
  stream_chunks=True)`` resolves to a lazy stream result.
* ``stats()``: queue depth, p50/p99 latency split at dispatch, mean
  occupancy, program-cache hits and overflow-ladder retries.

Every future resolves to a ``SortOutput`` (or raises the request's
terminal error). A coalesced result is CPU tensors (the flush copies its
decoded output to the host once) and carries ``meta.coalesced``; a
directly dispatched result is what ``repro_torch.sort`` returns, its
device work complete when the future resolves.

``device``: where the server sorts; None means "cuda" (raises without a
card; ``device="cpu"`` runs it on the CPU). The flush loop and the worker
threads run with that device current. A request submitted as a tensor on
that device is staged there; host requests cost one copy per flush.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

import contextlib

import numpy as np
import torch

from repro_torch import tune as _tune
from repro_torch.core import keyenc, planner
from repro_torch.core import topk as topk_lib
from repro_torch.core.overflow import SortOverflowError, bump_capacity
from repro_torch.core.result import SortMeta, SortOutput
from repro_torch.core.splitters import SortConfig
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.obs.slo import SLOConfig, SLOTracker
from repro_torch.stream.service import FlushEngine
from repro_torch.tune.adapt import AdaptConfig, AdaptiveController

# Process-wide serve metrics (see repro_torch.obs): every SortServer instance
# publishes into these families, mirroring the per-instance stats()
# dict in the shared Prometheus registry. Queue-wait and execute are
# split on purpose — conflated, backpressure (deep queue) is
# indistinguishable from slow programs (long flushes).
_LAT_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 10000.0, float("inf"))
_M_REQUESTS = obs_metrics.counter(
    "sortd_requests_total",
    "Sort-server requests by terminal outcome.",
    labels=("outcome",),  # submitted|completed|failed|cancelled|rejected
)
_M_QUEUE_DEPTH = obs_metrics.gauge(
    "sortd_queue_depth", "Pending requests across all buckets."
)
_M_QUEUE_WAIT = obs_metrics.histogram(
    "sortd_queue_wait_ms", "Request wait from submit to dispatch (ms).",
    buckets=_LAT_BUCKETS_MS,
)
_M_EXECUTE = obs_metrics.histogram(
    "sortd_execute_ms", "Request execution from dispatch to resolve (ms).",
    buckets=_LAT_BUCKETS_MS,
)
_M_LATENCY = obs_metrics.histogram(
    "sortd_latency_ms", "End-to-end request latency, submit to resolve (ms).",
    buckets=_LAT_BUCKETS_MS,
)
_M_FLUSHES = obs_metrics.counter(
    "sortd_flushes_total", "Dispatch groups fired, by kind.",
    labels=("kind",),  # coalesced|direct
)
_M_COALESCED = obs_metrics.counter(
    "sortd_coalesced_requests_total",
    "Requests that shared a batched coalesced flush.",
)
_M_FLUSH_TRIGGER = obs_metrics.counter(
    "sortd_flush_trigger_total",
    "Why each dispatch group fired: slot target reached, deadline "
    "expired, explicit flush(), or server close/drain.",
    labels=("trigger",),  # slots|deadline|forced|close
)
_M_ADMISSION = obs_metrics.counter(
    "sortd_admission_total",
    "Admission-control verdicts: admitted, rejected on queue depth, or "
    "rejected on the cost-model budget (max_queue_cost_us).",
    labels=("verdict",),  # admitted|queue_depth|queue_cost
)
_M_TENANT_REQUESTS = obs_metrics.counter(
    "repro_tenant_requests_total",
    "Per-tenant request outcomes on the sort server.",
    labels=("tenant", "outcome"),  # submitted|completed|failed|rejected
)
_M_TENANT_DEPTH = obs_metrics.gauge(
    "repro_tenant_queue_depth",
    "Pending requests per tenant across all buckets.",
    labels=("tenant",),
)


class QueueFullError(RuntimeError):
    """Admission control rejected the request: the server already holds
    ``max_queue`` pending requests. ``retry_after_ms`` is the server's
    estimate of when capacity frees (the next flush deadline) — clients
    should back off at least that long before resubmitting."""

    def __init__(self, msg: str, retry_after_ms: float):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


class RequestTooLargeError(ValueError):
    """A single request exceeded ``SortLimits.max_request_elems``."""


class SortFuture(Future):
    """``concurrent.futures.Future`` resolving to the request's
    ``SortOutput``. ``cancel()`` succeeds while the request is still
    queued (before its flush starts); ``result(timeout)`` / ``done()`` /
    ``exception()`` / ``add_done_callback()`` behave as in the stdlib."""


class _Pending:
    """One admitted request waiting in a bucket."""

    __slots__ = ("fut", "req", "plan", "data", "t_submit", "t_dispatch",
                 "ctx", "post", "tenant", "priority", "vtag", "cost",
                 "stream_chunks")

    def __init__(self, fut, req, plan, data, t_submit, ctx):
        self.fut = fut
        self.req = req          # normalized planner request (direct path)
        self.plan = plan        # SortPlan made at admission
        self.data = data        # flat np array (coalescable path), else None
        self.t_submit = t_submit
        self.t_dispatch = None  # set when the flush/worker picks it up:
        #                         splits latency into queue-wait + execute
        #                         (direct requests: pool queue time counts
        #                         as queue-wait — it IS backpressure)
        self.ctx = ctx          # obs.flight.RequestContext (trace_id etc.)
        self.post = None        # sort-adjacent request types: host view
        #                         applied to the sorted result at resolve
        self.tenant = "default"
        self.priority = 0       # lower dispatches first
        self.vtag = 0.0         # WFQ virtual finish tag (start + cost/w)
        self.cost = None        # model-priced cost (us); None when the
        #                         tune model is cold (depth bound only)
        self.stream_chunks = False


class _Tenant:
    """Per-tenant fair-queuing state (guarded by the server lock)."""

    __slots__ = ("name", "weight", "vtime", "submitted", "completed",
                 "failed", "rejected", "depth")

    def __init__(self, name: str, weight: float = 1.0):
        self.name = name
        self.weight = float(weight)
        self.vtime = 0.0        # virtual clock: finish tag of the
        #                         tenant's most recent submission
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.depth = 0


def _rough_n(keys) -> int:
    """Pre-planning element-count estimate (cost pre-check only)."""
    try:
        if isinstance(keys, (tuple, list)) and keys:
            keys = keys[0]
        if isinstance(keys, torch.Tensor):
            return keys.numel()
        return int(np.size(keys))
    except Exception:  # noqa: BLE001 — iterators etc.: planner decides later
        return 0


def _rough_dtype(keys):
    if isinstance(keys, (tuple, list)) and keys:
        keys = keys[0]
    return getattr(keys, "dtype", None)


def _single_key(keys, what: str) -> None:
    if isinstance(keys, (tuple, list)):
        raise ValueError(f"{what} requests are single-key only")


class SortServer:
    """Asynchronous micro-batching sort server with latency targets.

    max_batch: a shape bucket flushes as soon as it holds this many
      requests (slot target). Also the flush batch cap of the
      shared ``FlushEngine``.
    max_delay_ms: latency deadline — a nonempty bucket flushes when its
      OLDEST request has waited this long, so a lone request never waits
      for a full batch. Non-coalescable requests dispatch on the next
      loop wakeup (no artificial delay: batching cannot help them).
    max_queue: admission bound on pending requests across all buckets;
      submits beyond it raise ``QueueFullError`` with a retry-after hint.
    limits / config / investigator: planner defaults for every request
      (overridable per submit). ``limits.n_procs`` shapes the engine's
      grid; ``limits.max_request_elems`` is the per-request size cap.
    direct_workers: worker threads for non-coalescable dispatches. A
      stream/mesh request can run for seconds; executing it inline in
      the flush loop would head-of-line block every coalescable bucket
      past its deadline, so direct requests run on this small pool while
      the loop keeps servicing slot/deadline targets.
    adapt: optional ``repro_torch.tune.AdaptConfig`` (or a pre-built
      ``AdaptiveController``) enabling closed-loop tuning of
      ``max_delay_ms``/``max_batch`` against the config's p99 objective:
      the flush loop periodically evaluates the live latency window and
      moves the knobs within the config's hard bounds (hysteresis +
      patience keep them from flapping; see ``repro_torch.tune.adapt``).
      ``stats()`` then reports the live values plus an ``adaptations``
      count, and the ``repro_tune_serve_*`` gauges track them in the
      metrics registry. Default None: the static knobs are used
      unchanged, bit-identical to the pre-tune server.
    slo: optional ``repro_torch.obs.SLOConfig`` (or a pre-built
      ``SLOTracker``) — every end-to-end latency is judged against the
      declared threshold/error-budget, the burn-rate gauges
      (``repro_slo_*``) land in the metrics registry, and ``stats()``
      gains an ``slo`` snapshot. Default None; an adaptive server with
      no explicit SLO derives one from the SAME ``AdaptConfig``
      objective the controller steers on (``SLOConfig.from_adapt``).
    deadline_miss_factor: flight-recorder anomaly threshold — a request
      whose end-to-end latency exceeds ``factor * max_delay_ms`` dumps
      a ``deadline_miss`` incident snapshot (see ``repro_torch.obs.flight``).
    tenants: optional ``{name: weight}`` map declaring tenant weights
      for weighted-fair dispatch (see the module docstring). Tenants
      not declared here are created on first use with weight 1.0;
      ``set_tenant`` adjusts weights live.
    max_queue_cost_us: optional cost-model admission budget. When an
      ambient ``repro_torch.tune`` tuner prices requests confidently, a
      submit whose predicted cost would push the queued total past
      this many microseconds is rejected (``QueueFullError``,
      ``sortd_admission_total{verdict="queue_cost"}``) with a
      model-derived ``retry_after_ms``. Unpriced requests (cold model)
      are bounded by ``max_queue`` depth only, and an over-budget
      request arriving at an EMPTY queue is admitted rather than
      rejected forever. Default None: depth-only admission.

    Every request is minted a ``trace_id`` at submit and its timeline
    (queue-wait -> flush/dispatch -> resolve, with the linking
    ``flush_id`` and the flush's stage/sort/d2h phase split) is recorded
    in the process-wide flight recorder (``obs.flight.RECORDER``) —
    always on, bounded memory; inspect with ``python -m repro_torch.obsctl``.

    The server starts its flush thread on construction; use it as a
    context manager (or call ``close()``) to drain and stop it.
    """

    def __init__(self, *, max_batch: int = 16, max_delay_ms: float = 5.0,
                 max_queue: int = 1024, limits=None,
                 config: SortConfig | None = None, investigator: bool = True,
                 direct_workers: int = 2, latency_window: int = 2048,
                 adapt: AdaptConfig | AdaptiveController | None = None,
                 slo: SLOConfig | SLOTracker | None = None,
                 deadline_miss_factor: float = 8.0,
                 tenants: dict[str, float] | None = None,
                 max_queue_cost_us: float | None = None, device=None):
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self.max_queue = int(max_queue)
        self.max_queue_cost_us = (
            float(max_queue_cost_us) if max_queue_cost_us is not None else None
        )
        # WFQ state: per-tenant virtual clocks plus the server-wide
        # virtual clock (advanced to the max dispatched finish tag, so
        # an idle tenant cannot bank credit while away)
        self._tenants: dict[str, _Tenant] = {
            name: _Tenant(name, w) for name, w in (tenants or {}).items()
        }
        self._vclock = 0.0
        self._queued_cost_us = 0.0  # model-priced pending work
        self.limits = limits if limits is not None else planner.SortLimits()
        self.config = config if config is not None else SortConfig()
        self.investigator = investigator
        self._adapt = None
        self._adapt_last = 0.0
        self._adapt_seen = 0
        engine_batch = self.max_batch
        if adapt is not None:
            ctrl = (adapt if isinstance(adapt, AdaptiveController)
                    else AdaptiveController(adapt, delay_ms=max_delay_ms,
                                            batch=max_batch))
            self._adapt = ctrl
            # start from the controller's (bounds-clamped) view
            self.max_delay = ctrl.delay_ms / 1e3
            self.max_batch = ctrl.batch
            # the engine's flush batch cap must cover the controller's
            # whole range, or growing max_batch would silently slice
            engine_batch = max(engine_batch, ctrl.config.max_batch)
        if slo is None and self._adapt is not None:
            slo = SLOConfig.from_adapt(self._adapt.config)
        self._slo = (slo if isinstance(slo, SLOTracker)
                     else SLOTracker(slo) if slo is not None else None)
        self._flight = obs_flight.RECORDER
        self.deadline_miss_factor = float(deadline_miss_factor)
        self._adapt_sat_seen = (self._adapt.bound_saturations
                                if self._adapt is not None else 0)
        self._stats = {
            "submitted": 0, "completed": 0, "failed": 0, "cancelled": 0,
            "rejected": 0, "flushes": 0, "flushed_requests": 0,
            "direct_dispatches": 0,
        }
        self._cond = threading.Condition()
        self._engine = FlushEngine(
            config=self.config, n_procs=self.limits.n_procs,
            investigator=self.investigator,
            max_doublings=self.limits.max_doublings,
            growth=self.limits.growth,
            max_batch=engine_batch, stats=self._stats,
            # the direct-dispatch workers add to stats["retries"] under
            # this same lock; sharing it keeps the counter exact
            stats_lock=self._cond, device=device,
        )
        self.device = self._engine.device
        self._direct_pool = ThreadPoolExecutor(
            max_workers=int(direct_workers), thread_name_prefix="sortd-direct"
        )
        # request latencies (seconds); appended and snapshotted under the
        # condition lock — stats() iterates them. _lat is end-to-end
        # (submit -> resolve); _lat_queue / _lat_exec split it at
        # dispatch so backpressure and slow programs read separately
        self._lat: deque[float] = deque(maxlen=int(latency_window))
        self._lat_queue: deque[float] = deque(maxlen=int(latency_window))
        self._lat_exec: deque[float] = deque(maxlen=int(latency_window))
        self._buckets: dict[tuple, list[_Pending]] = {}
        self._depth = 0
        self._seq = 0
        self._closed = False
        self._force = False
        self._thread = threading.Thread(
            target=self._run_loop, name="sortd-flush", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ client
    def submit(self, keys, values=None, *, order="asc", want="values",
               where=None, limits=None, config=None, investigator=None,
               tenant: str | None = None, priority: int = 0,
               stream_chunks: bool = False) -> SortFuture:
        """Plan + enqueue one sort request; returns immediately.

        Accepts ``repro_torch.sort``'s keyword surface; per-request overrides
        fall back to the server defaults. Raises ``TypeError`` /
        ``ValueError`` for invalid requests, ``RequestTooLargeError`` and
        ``QueueFullError`` for admission failures — all synchronously at
        submit, never on the future.

        ``tenant`` names the submitting client for weighted-fair
        dispatch (None = the shared ``"default"`` tenant); ``priority``
        is the request's class — lower values dispatch first within the
        fair order. ``stream_chunks=True`` (keys-only, stream backend)
        resolves the future to a LAZY ``SortOutput``: consume
        ``.chunks()`` for sorted chunks in bounded memory."""
        return self._submit(keys, values, order=order, want=want,
                            where=where, limits=limits, config=config,
                            investigator=investigator, tenant=tenant,
                            priority=priority, stream_chunks=stream_chunks)

    def _submit(self, keys, values=None, *, order="asc", want="values",
                where=None, limits=None, config=None, investigator=None,
                tenant=None, priority=0, stream_chunks=False,
                post=None) -> SortFuture:
        tname = str(tenant) if tenant is not None else "default"
        # cheap admission pre-check BEFORE planning: serve_profile
        # measures multi-key pack widths (O(n * n_keys) host rank work)
        # and packing costs the same again, so a saturated queue must
        # reject without paying either — retry-hammering clients under
        # backpressure would otherwise burn that host CPU on every
        # doomed submit. The check at enqueue below remains the atomic,
        # authoritative one (the queue can fill during planning). The
        # cost pre-check prices the request from the raw input (size and
        # dtype are knowable without planning).
        est = self._price(_rough_n(keys), _rough_dtype(keys))
        with self._cond:
            if self._closed:
                raise RuntimeError("SortServer is closed")
            retry_ms = reason = None
            verdict = self._admission_verdict(est)
            if verdict is not None:
                reason = self._count_rejection(tname, verdict)
                retry_ms = self._retry_after_ms(time.monotonic(),
                                                cost_us=est)
        if retry_ms is not None:
            self._reject(retry_ms, reason)
        cfg = config if config is not None else self.config
        inv = self.investigator if investigator is None else investigator
        lim = limits if limits is not None else self.limits
        req, plan, batchable = planner.serve_profile(
            keys, values, order=order, want=want, where=where,
            limits=lim, config=cfg, investigator=inv, device=self.device,
        )
        cap = lim.max_request_elems
        if cap is not None and (req.n or 0) > cap:
            raise RequestTooLargeError(
                f"request of {req.n} elements exceeds "
                f"SortLimits.max_request_elems={cap}; split it or sort it "
                f"directly with repro_torch.sort"
            )
        if stream_chunks:
            if values is not None or want != "values":
                raise ValueError(
                    "stream_chunks=True serves keys-only sorted chunks "
                    "(no values/argsort payload)"
                )
            if plan.backend != "stream":
                raise ValueError(
                    "stream_chunks=True needs the out-of-core backend "
                    f"(planned backend={plan.backend!r}); pass "
                    "where='stream' or submit past stream_threshold"
                )
            batchable = False  # chunk responses dispatch individually
        # a request may only join a batched flush when it would both
        # compile against the engine's exact program (config / grid /
        # investigator) AND walk the engine's exact overflow ladder — a
        # caller asking for a different retry policy must not silently
        # inherit the server's. Same for decode="host": the fused batch
        # program decodes on device, so a legacy-decode request must
        # dispatch individually to actually exercise the host path
        batchable = (
            batchable and cfg == self.config and inv == self.investigator
            and lim.n_procs == self.limits.n_procs
            and lim.max_doublings == self.limits.max_doublings
            and lim.growth == self.limits.growth
            and lim.decode == "device"
        )
        data = None
        if batchable:
            if req.multikey:
                # packed multi-key: stage the fused ascending integer key
                # — spec.pack_dtype, so 32/64-bit packs bucket apart —
                # (per-key order flips live inside the bit fields; the
                # rank arrays measured at plan time are reused)
                data = keyenc.pack_keys(req.keys, plan.packspec,
                                        ranks=req.pack_ranks)
            else:
                data = req.keys.reshape(-1)

        fut = SortFuture()
        now = time.monotonic()
        # request-scoped identity: the trace_id minted here follows the
        # request through the flush loop / worker pool into the flight
        # recorder and onto the result's meta.trace_id
        ctx = obs_flight.RequestContext(
            now, kind="coalesced" if batchable else "direct",
            n=req.n or 0, dtype=req.dtype, backend=plan.backend,
        )
        pend = _Pending(fut, req, plan, data, now, ctx)
        pend.post = post
        pend.tenant = tname
        pend.priority = int(priority)
        pend.stream_chunks = stream_chunks
        # authoritative price, from the planned request (the pre-check
        # estimated from the raw input)
        pend.cost = self._price(req.n or 0, req.dtype, plan.backend)
        retry_ms = reason = None
        with self._cond:
            if self._closed:
                raise RuntimeError("SortServer is closed")
            verdict = self._admission_verdict(pend.cost)
            if verdict is not None:
                # the queue filled during planning: reject below, outside
                # the lock (the burst trigger may write a snapshot file)
                reason = self._count_rejection(tname, verdict)
                retry_ms = self._retry_after_ms(now, cost_us=pend.cost)
            else:
                ten = self._tenant(tname)
                # start-time fair queuing: virtual start = max(server
                # clock, tenant clock); finish tag = start + cost/weight.
                # The model's price is the cost when it predicts
                # confidently; the element count is the cold-model proxy
                # (fairness only needs costs consistent across tenants).
                cost_proxy = (pend.cost if pend.cost is not None
                              else float(req.n or 1))
                ten.vtime = (max(self._vclock, ten.vtime)
                             + cost_proxy / ten.weight)
                pend.vtag = ten.vtime
                if pend.cost is not None:
                    self._queued_cost_us += pend.cost
                ten.submitted += 1
                ten.depth += 1
                if batchable:
                    # descending requests bucket separately (same shapes,
                    # a flush that flips in its decode), and packed
                    # multi-key requests bucket per PackSpec (the flush's
                    # unpack follows the spec)
                    desc = bool(req.descending[0]) and not req.multikey
                    pspec = plan.packspec if req.multikey else None
                    key = (("batch", desc, pspec)
                           + self._engine.bucket_key(data))
                else:
                    self._seq += 1
                    key = ("direct", self._seq)
                self._buckets.setdefault(key, []).append(pend)
                self._depth += 1
                self._stats["submitted"] += 1
                _M_REQUESTS.labels(outcome="submitted").inc()
                _M_ADMISSION.labels(verdict="admitted").inc()
                _M_TENANT_REQUESTS.labels(
                    tenant=tname, outcome="submitted").inc()
                _M_TENANT_DEPTH.labels(tenant=tname).set(ten.depth)
                _M_QUEUE_DEPTH.set(self._depth)
                self._cond.notify()
        if retry_ms is not None:
            self._reject(retry_ms, reason)
        return fut

    # ------------------------------------------------- admission / tenants
    def _admission_verdict(self, cost_us: float | None) -> str | None:
        """Called under the lock: None = admit, else the rejection
        verdict. The cost budget only binds when the model priced the
        request (cold model -> depth bound only) and the queue is
        nonempty (an over-budget request must not starve forever)."""
        if self._depth >= self.max_queue:
            return "queue_depth"
        if (self.max_queue_cost_us is not None and cost_us is not None
                and self._depth > 0
                and self._queued_cost_us + cost_us > self.max_queue_cost_us):
            return "queue_cost"
        return None

    def _count_rejection(self, tname: str, verdict: str) -> str:
        """Called under the lock: account a rejection, return the
        client-facing reason string."""
        self._stats["rejected"] += 1
        ten = self._tenant(tname)
        ten.rejected += 1
        _M_ADMISSION.labels(verdict=verdict).inc()
        _M_TENANT_REQUESTS.labels(tenant=tname, outcome="rejected").inc()
        if verdict == "queue_cost":
            return (
                f"sort queue over cost budget (~{self._queued_cost_us:.0f}us "
                f"of queued work, max_queue_cost_us={self.max_queue_cost_us:.0f})"
            )
        return f"sort queue full ({self.max_queue} pending requests)"

    def _price(self, n, dtype, backend: str = "sim") -> float | None:
        """Cost-model price of one request in microseconds; None when no
        ambient ``repro_torch.tune`` tuner predicts confidently (cold model).
        Cold behavior is therefore bit-identical to the unpriced server:
        depth-only admission and element-count fair tags."""
        tuner = _tune.current()
        if tuner is None or not n or dtype is None:
            return None
        try:
            pred = tuner.model.predict(
                "sort", backend, dtype, int(n))
        except Exception:  # noqa: BLE001 — pricing must never block admission
            return None
        if pred is None or pred.confidence < tuner.min_confidence:
            return None
        return float(pred.us)

    def _tenant(self, name: str) -> _Tenant:
        """Called under the lock: get-or-create (weight 1.0) a tenant."""
        ten = self._tenants.get(name)
        if ten is None:
            ten = self._tenants[name] = _Tenant(name)
        return ten

    def set_tenant(self, name: str, weight: float = 1.0) -> None:
        """Declare or re-weight a tenant (live: affects the fair tags of
        future submits; queued requests keep the tags they were admitted
        with)."""
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        with self._cond:
            self._tenant(name).weight = float(weight)

    def _reject(self, retry_after_ms: float, reason: str | None = None) -> None:
        """Admission rejection (stats already counted under the lock):
        feed the flight recorder's burst detector and raise. A burst —
        ``burst_threshold`` rejections inside ``burst_window_s`` — dumps
        a ``queue_full_burst`` incident snapshot."""
        _M_REQUESTS.labels(outcome="rejected").inc()
        if self._flight.record_rejection():
            self._flight_anomaly("queue_full_burst", {
                "max_queue": self.max_queue,
                "retry_after_ms": retry_after_ms,
            })
        raise QueueFullError(
            reason or f"sort queue full ({self.max_queue} pending requests)",
            retry_after_ms=retry_after_ms,
        )

    def _flight_anomaly(self, kind: str, detail: dict) -> None:
        """Refresh the recorder's controller/SLO state, then trigger —
        incident snapshots carry the knob positions of the moment."""
        if self._adapt is not None:
            self._flight.record_adaptive(self._adapt_state())
        if self._slo is not None:
            self._flight.record_slo(self._slo.snapshot())
        self._flight.anomaly(kind, detail)

    def _adapt_state(self) -> dict:
        ctrl = self._adapt
        return {
            "delay_ms": ctrl.delay_ms,
            "batch": ctrl.batch,
            "adjustments": ctrl.adjustments,
            "bound_saturations": ctrl.bound_saturations,
            "saturated_at": ctrl.saturated_at,
        }

    def sort_many_async(self, arrays, **sort_kwargs) -> list[SortOutput]:
        """Submit every array, then wait for all: micro-batched execution
        behind a synchronous signature (the async ``sort_many``)."""
        futs = [self.submit(a, **sort_kwargs) for a in arrays]
        return [f.result() for f in futs]

    # ------------------------------------------- sort-adjacent requests
    # All three plan as ordinary keys-only sorts, so they coalesce into
    # the same flush buckets as plain sort traffic; the answer is a host
    # view over the sorted keys (core.topk *_sorted helpers — the exact
    # code behind SortOutput.topk/.searchsorted, hence bit-identical to
    # sort-then-slice), applied at resolve time on the dispatch thread.
    # The resolved SortOutput reuses the sort's meta (meta.want names
    # the request kind; meta.coalesced proves batch membership) and its
    # .keys hold the answer.

    def submit_topk(self, keys, k: int, *, largest: bool = True,
                    order="asc", where=None, limits=None, config=None,
                    investigator=None, tenant: str | None = None,
                    priority: int = 0) -> SortFuture:
        """Serve the top-``k`` keys, best first (``largest=False`` for
        the bottom-k). Resolves to a ``SortOutput`` whose ``.keys`` is
        the k-vector — bit-identical to
        ``repro_torch.sort(keys, ...).topk(k, largest)``."""
        _single_key(keys, "topk")
        k = int(k)

        def post(out: SortOutput) -> SortOutput:
            ans = topk_lib.topk_sorted(
                out.keys, k, largest=largest,
                descending=out.meta.order == "desc")
            return self._view_output(out, "topk", ans)

        return self._submit(keys, order=order, where=where, limits=limits,
                            config=config, investigator=investigator,
                            tenant=tenant, priority=priority, post=post)

    def submit_searchsorted(self, keys, queries, *, side: str = "left",
                            order="asc", where=None, limits=None,
                            config=None, investigator=None,
                            tenant: str | None = None,
                            priority: int = 0) -> SortFuture:
        """Serve the global insertion ranks of ``queries`` into the
        sorted keys (np.searchsorted semantics, descending-aware) —
        bit-identical to ``repro_torch.sort(keys, ...).searchsorted(q, side)``."""
        _single_key(keys, "searchsorted")
        q = queries

        def post(out: SortOutput) -> SortOutput:
            ans = topk_lib.searchsorted_sorted(
                out.keys, q, side=side,
                descending=out.meta.order == "desc")
            return self._view_output(out, "searchsorted", ans)

        return self._submit(keys, order=order, where=where, limits=limits,
                            config=config, investigator=investigator,
                            tenant=tenant, priority=priority, post=post)

    def submit_percentile(self, keys, q, *, order="asc", where=None,
                          limits=None, config=None, investigator=None,
                          tenant: str | None = None,
                          priority: int = 0) -> SortFuture:
        """Serve percentile(s) of the keys (numpy linear interpolation,
        exactly ``np.percentile``)."""
        _single_key(keys, "percentile")
        q = np.asarray(q, np.float64)

        def post(out: SortOutput) -> SortOutput:
            ans = topk_lib.percentile_sorted(
                out.keys, q,
                descending=out.meta.order == "desc")
            return self._view_output(out, "percentile", ans)

        return self._submit(keys, order=order, where=where, limits=limits,
                            config=config, investigator=investigator,
                            tenant=tenant, priority=priority, post=post)

    @staticmethod
    def _view_output(out: SortOutput, kind: str, ans) -> SortOutput:
        # reuse the sort's meta so coalesced/trace_id/flush_id survive
        # on the served view; want names the request kind
        out.meta.want = kind
        return SortOutput(out.meta, keys=ans)

    def flush(self, timeout: float | None = None) -> None:
        """Force-flush everything queued now and block until it resolves
        (deadlines and slot targets are bypassed once)."""
        with self._cond:
            futs = [p.fut for pends in self._buckets.values() for p in pends]
            self._force = True
            self._cond.notify()
        for f in futs:
            try:
                f.result(timeout)
            except Exception:
                pass  # the error belongs to that future's owner

    def stats(self) -> dict:
        """Telemetry snapshot: queue depth, latency percentiles (ms),
        batch occupancy (``flushes``/``flushed_requests``/
        ``occupancy_mean`` cover COALESCED flushes only; individually
        dispatched requests are counted in ``direct_dispatches``),
        program-cache and overflow-ladder counters.

        End-to-end latency splits at dispatch: ``queue_wait_ms_*``
        (submit -> dispatch; deep values mean backpressure) and
        ``execute_ms_*`` (dispatch -> resolve; deep values mean slow
        programs). The same samples feed the process-wide
        ``sortd_queue_wait_ms`` / ``sortd_execute_ms`` histograms in
        ``repro_torch.obs`` (scrape with ``obs.render_prometheus()``)."""
        with self._cond:
            s = dict(self._stats)
            depth = self._depth
            lat_ms = np.asarray(self._lat, np.float64) * 1e3
            queue_ms = np.asarray(self._lat_queue, np.float64) * 1e3
            exec_ms = np.asarray(self._lat_exec, np.float64) * 1e3
            tenants = {
                name: {"weight": t.weight, "vtime": t.vtime,
                       "submitted": t.submitted, "completed": t.completed,
                       "failed": t.failed, "rejected": t.rejected,
                       "depth": t.depth}
                for name, t in self._tenants.items()
            }
            queued_cost = self._queued_cost_us
        flushes = s["flushes"]

        def _pct(arr, q):
            return float(np.percentile(arr, q)) if arr.size else None

        s.update(
            queue_depth=depth,
            occupancy_mean=(s["flushed_requests"] / flushes) if flushes else 0.0,
            latency_ms_p50=_pct(lat_ms, 50),
            latency_ms_p99=_pct(lat_ms, 99),
            queue_wait_ms_p50=_pct(queue_ms, 50),
            queue_wait_ms_p99=_pct(queue_ms, 99),
            execute_ms_p50=_pct(exec_ms, 50),
            execute_ms_p99=_pct(exec_ms, 99),
        )
        if self._adapt is not None:
            # live knob values + controller activity (stats() gains these
            # keys only on adaptive servers: static snapshots unchanged)
            s.update(
                adaptive=True,
                max_delay_ms=self.max_delay * 1e3,
                max_batch=self.max_batch,
                adaptations=self._adapt.adjustments,
                bound_saturations=self._adapt.bound_saturations,
            )
        if tenants:
            # per-tenant fair-queuing state (only tenants actually seen;
            # an all-default workload reports the one "default" entry)
            s["tenants"] = tenants
        s["admission"] = {
            "max_queue": self.max_queue,
            "max_queue_cost_us": self.max_queue_cost_us,
            "queued_cost_us": queued_cost,
        }
        if self._slo is not None:
            # declared objective + live burn rate (see repro_torch.obs.slo);
            # the same numbers scrape as the repro_slo_* gauges
            s["slo"] = self._slo.snapshot()
        return s

    def close(self, timeout: float | None = None) -> None:
        """Drain every queued request, then stop the flush thread and the
        direct-dispatch pool (waiting for in-flight direct requests)."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout)
        self._direct_pool.shutdown(wait=True)

    def __enter__(self) -> "SortServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------- flush loop
    def _deadline(self, key: tuple, pends: list[_Pending]) -> float:
        # oldest request anchors the bucket deadline; direct requests get
        # no artificial delay — batching cannot help them
        delay = self.max_delay if key[0] == "batch" else 0.0
        return pends[0].t_submit + delay

    def _retry_after_ms(self, now: float, cost_us: float | None = None) -> float:
        """Called under the lock: backoff hint for a rejected submit.

        When the cost model priced the rejected request (``cost_us``),
        the hint is the predicted DRAIN time — the queued work's priced
        microseconds plus the rejected request's own price — which is
        monotone in request size (bigger rejected sorts are told to back
        off longer). Cold model: the static guess, time until the next
        flush deadline frees slots."""
        if cost_us is not None:
            return (self._queued_cost_us + cost_us) / 1e3
        deadlines = [
            self._deadline(k, p) for k, p in self._buckets.items() if p
        ]
        if not deadlines:
            return self.max_delay * 1e3
        return max(0.0, min(deadlines) - now) * 1e3

    def _select_ready(self, now: float) -> list[tuple]:
        ready = []
        for key, pends in self._buckets.items():
            if not pends:
                continue
            full = key[0] == "batch" and len(pends) >= self.max_batch
            if self._force or self._closed or full or self._deadline(key, pends) <= now:
                ready.append(key)
                # why this bucket fired — per-bucket flush-kind telemetry
                # (batching efficiency: deadline-heavy traffic means the
                # coalescing window rarely fills its slot target)
                trigger = ("slots" if full
                           else "forced" if self._force
                           else "close" if self._closed
                           else "deadline")
                _M_FLUSH_TRIGGER.labels(trigger=trigger).inc()
        return ready

    def _wait_timeout(self, now: float) -> float | None:
        deadlines = [
            self._deadline(k, p) for k, p in self._buckets.items() if p
        ]
        if not deadlines:
            return None  # sleep until a submit notifies
        return max(0.0, min(deadlines) - now)

    def _on_device(self):
        """The server's CUDA device made current (it is per thread)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _run_loop(self) -> None:
        with self._on_device():
            self._loop()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    now = time.monotonic()
                    ready = self._select_ready(now)
                    if ready:
                        break
                    self._force = False  # nothing left to force-flush
                    if self._closed:
                        return
                    self._cond.wait(self._wait_timeout(now))
                # force stays set until the queue fully drains (the wait
                # loop clears it when nothing is ready): an oversized
                # bucket dispatches max_batch per pass, and a forced
                # flush must also sweep the sub-max_batch remainder
                # whose deadline may be far out — flush() promises
                # "everything queued now", not "one dispatch group"
                work = [(k, self._take(k)) for k in ready]
                # groups dispatch in fair order too — the group whose
                # best member has the lowest fair key goes first, so
                # priority classes order the direct pool's queue as well
                work.sort(key=lambda kp: self._fair_key(kp[1][0]))
                self._depth -= sum(len(p) for _, p in work)
                for _, pends in work:
                    for p in pends:
                        if p.cost is not None:
                            self._queued_cost_us -= p.cost
                        ten = self._tenants.get(p.tenant)
                        if ten is not None:
                            ten.depth -= 1
                            _M_TENANT_DEPTH.labels(
                                tenant=p.tenant).set(ten.depth)
                        # the server's virtual clock chases the highest
                        # dispatched finish tag: a tenant returning from
                        # idle starts at the current clock, not at zero
                        if p.vtag > self._vclock:
                            self._vclock = p.vtag
                self._queued_cost_us = max(self._queued_cost_us, 0.0)
                _M_QUEUE_DEPTH.set(self._depth)
                # queue-depth history for incident snapshots (leaf-lock
                # deque append — never blocks on I/O)
                self._flight.record_queue_depth(self._depth, now)
            for key, pends in work:
                self._flush_group(key, pends)
            self._maybe_adapt()

    @staticmethod
    def _fair_key(p: _Pending) -> tuple:
        return (p.priority, p.vtag, p.t_submit)

    def _take(self, key: tuple) -> list[_Pending]:
        """Pop one dispatch group from a ready bucket (under the lock).

        A batch bucket dispatches at most ``max_batch`` requests per
        flush, chosen in weighted-fair order ``(priority, vtag,
        arrival)``; the remainder stays queued IN ARRIVAL ORDER (the
        bucket deadline keys off its oldest member). The remainder's
        deadline is already due, so the loop re-selects the bucket on
        its next pass — but anything submitted in between competes on
        fair tags, not arrival order, which is exactly how a light
        tenant's request overtakes a flooding tenant's queued backlog.
        """
        pends = self._buckets[key]
        if key[0] != "batch":
            del self._buckets[key]
            return pends
        if len(pends) <= self.max_batch:
            del self._buckets[key]
            return sorted(pends, key=self._fair_key)
        order = sorted(range(len(pends)),
                       key=lambda i: self._fair_key(pends[i]))
        chosen = set(order[: self.max_batch])
        self._buckets[key] = [
            p for i, p in enumerate(pends) if i not in chosen
        ]
        return [pends[i] for i in order[: self.max_batch]]

    def _maybe_adapt(self) -> None:
        """Adaptive-serve evaluation point, called from the flush loop
        between dispatch rounds: feed the controller the p99 of the
        latency samples completed since the previous evaluation and
        apply whatever knob values it settles on. No-op without
        ``adapt=``, and paced by the config's interval/min-sample gates
        so the controller reacts to windows, not to single requests."""
        ctrl = self._adapt
        if ctrl is None:
            return
        now = time.monotonic()
        if now - self._adapt_last < ctrl.config.interval_s:
            return
        with self._cond:
            completed = self._stats["completed"]
            fresh = completed - self._adapt_seen
            if fresh <= 0:
                return
            recent = list(self._lat)[-min(fresh, len(self._lat)):]
            depth = self._depth
        self._adapt_last = now
        self._adapt_seen = completed
        if not recent:
            return
        p99 = float(np.percentile(np.asarray(recent, np.float64) * 1e3, 99))
        if ctrl.update(p99, completed=fresh, queue_depth=depth):
            with self._cond:
                self.max_delay = ctrl.delay_ms / 1e3
                self.max_batch = ctrl.batch
        self._flight.record_adaptive(self._adapt_state())
        if ctrl.bound_saturations > self._adapt_sat_seen:
            # the controller wanted to move but every knob is pinned at
            # an operator bound — the objective is unreachable inside
            # the configured envelope; leave the evidence behind
            self._adapt_sat_seen = ctrl.bound_saturations
            self._flight_anomaly("adapt_bound_saturation", {
                "p99_ms": p99,
                "target_p99_ms": ctrl.config.target_p99_ms,
                "bound": ctrl.saturated_at,
            })

    # --------------------------------------------------------- execution
    def _flush_group(self, key: tuple, pends: list[_Pending]) -> None:
        live = []
        for p in pends:
            if p.fut.set_running_or_notify_cancel():
                live.append(p)
            else:
                p.ctx.finish("cancelled")
                self._flight.record_request(p.ctx.summary())
        cancelled = len(pends) - len(live)
        if cancelled:
            with self._cond:
                self._stats["cancelled"] += cancelled
            _M_REQUESTS.labels(outcome="cancelled").inc(cancelled)
        if not live:
            return
        with self._cond:
            # occupancy telemetry counts COALESCED flushes only: a direct
            # (kv/argsort/stream/mesh) dispatch is always a group of one
            # and would drag occupancy_mean down under mixed traffic
            if key[0] == "batch":
                self._stats["flushes"] += 1
                self._stats["flushed_requests"] += len(live)
            else:
                self._stats["direct_dispatches"] += len(live)
        if key[0] == "batch":
            _M_FLUSHES.labels(kind="coalesced").inc()
            _M_COALESCED.inc(len(live))
            t_dispatch = time.monotonic()
            for p in live:
                p.t_dispatch = t_dispatch
                p.ctx.dispatched(t_dispatch)
            try:
                # the engine links the flush's flush_id + stage/sort/d2h
                # phase split onto every member ctx and records ONE
                # flush summary carrying all member trace_ids
                results = self._engine.run_group(
                    [p.data for p in live], descending=key[1],
                    packspec=key[2], ctxs=[p.ctx for p in live])
            except Exception as e:  # noqa: BLE001 — an unexpected error
                # (a kernel build or launch failure, MemoryError staging the
                # batch, ...) must fail THESE futures, never kill the
                # flush thread and strand every later request
                for p in live:
                    self._fail(p, e)
                return
            for p, (res, retries) in zip(live, results):
                if isinstance(res, Exception):
                    self._fail(p, res)
                else:
                    self._resolve(
                        p, self._wrap_batched(p, res, len(live), retries))
        else:
            _M_FLUSHES.labels(kind="direct").inc(len(live))
            for p in live:
                # off the flush loop: a slow stream/mesh dispatch must
                # not hold coalescable buckets past their deadline
                self._direct_pool.submit(self._dispatch_direct, p)

    def _dispatch_direct(self, p: _Pending) -> None:
        with self._on_device():
            self._dispatch_direct_on_device(p)

    def _dispatch_direct_on_device(self, p: _Pending) -> None:
        # queue-wait for a direct request includes the worker-pool queue:
        # waiting for a free worker is backpressure, not execution
        p.t_dispatch = time.monotonic()
        p.ctx.dispatched(p.t_dispatch)
        # rate-sampled full phase traces: every Nth direct request runs
        # with a per-request Trace attached, so incident snapshots hold
        # complete plan->...->d2h breakdowns, not just coarse intervals
        tr = None
        if p.req.trace is None and self._flight.sample():
            tr = obs_tracing.Trace(labels={"backend": p.plan.backend,
                                           "trace_id": p.ctx.trace_id})
            p.req.trace = tr
            p.ctx.sampled = True
        try:
            out = planner.execute_request(p.req, p.plan, ctx=p.ctx)
            if p.stream_chunks:
                # chunk-stream response: resolve the LAZY output — the
                # sort runs in bounded memory as the client consumes
                # .chunks(). Materializing here would defeat the point;
                # ladder accounting happens when the stream actually runs
                self._record_sampled(p, tr)
                self._resolve(p, out)
                return
            # materialize HERE so terminal errors land on the future (not
            # in the caller's .keys access) and the stream backend's
            # ladder accounting is complete; the device work is waited
            # for, so the latency is the sort's, not its enqueue's
            _ = out.keys
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            with self._cond:
                self._stats["retries"] += int(out.meta.retries)
            p.ctx.retries = int(out.meta.retries)
            self._record_sampled(p, tr)
            self._resolve(p, out)
        except Exception as e:  # noqa: BLE001 — future owns it
            self._record_sampled(p, tr)
            self._fail(p, e)

    def _record_sampled(self, p: _Pending, tr) -> None:
        if tr is None:
            return
        p.ctx.phases = {f"{name}_ms": s * 1e3
                        for name, s in tr.phase_totals().items()}
        self._flight.record_trace(p.ctx.trace_id, [
            {"name": s.name, "t0": s.t0, "t1": s.t1,
             "attrs": {k: v for k, v in s.attrs.items()
                       if isinstance(v, (int, float, str, bool))}}
            for s in tr.spans
        ])

    def _wrap_batched(self, p: _Pending, arr,
                      occupancy: int, retries: int) -> SortOutput:
        # meta.config is documented as the config ACTUALLY used after
        # capacity retries; the engine's ladder is deterministic (one
        # capacity bump per step), so reconstruct it from the step count
        cfg = self.config
        for _ in range(retries):
            cfg = bump_capacity(cfg, self._engine.policy)
        orders = tuple("desc" if d else "asc" for d in p.req.descending)
        meta = SortMeta(
            backend="sim", plan=p.plan, config=cfg,
            n=p.req.n or 0, want="values",
            order=orders[0] if len(orders) == 1 else orders,
            n_keys=len(orders), dtype=p.req.dtype, coalesced=occupancy,
            retries=retries,
            multikey="packed" if isinstance(arr, tuple) else None,
            trace_id=p.ctx.trace_id, flush_id=p.ctx.flush_id,
        )
        # packed multi-key flushes resolve to the unpacked column tuple
        return SortOutput(meta, keys=arr)

    def _record_latency(self, p: _Pending, now: float) -> None:
        """Called under the lock: record total + split latency samples."""
        total = now - p.t_submit
        t_d = p.t_dispatch if p.t_dispatch is not None else now
        queue_wait = t_d - p.t_submit
        execute = now - t_d
        self._lat.append(total)
        self._lat_queue.append(queue_wait)
        self._lat_exec.append(execute)
        _M_LATENCY.observe(total * 1e3)
        _M_QUEUE_WAIT.observe(queue_wait * 1e3)
        _M_EXECUTE.observe(execute * 1e3)

    def _resolve(self, p: _Pending, out: SortOutput) -> None:
        if p.post is not None:
            # sort-adjacent request types: derive the served view from
            # the sorted keys here on the dispatch thread, so a failing
            # view lands on the future rather than in the client
            try:
                out = p.post(out)
            except Exception as e:  # noqa: BLE001 — future owns it
                self._fail(p, e)
                return
        now = time.monotonic()
        with self._cond:
            self._record_latency(p, now)
            self._stats["completed"] += 1
            ten = self._tenants.get(p.tenant)
            if ten is not None:
                ten.completed += 1
        _M_REQUESTS.labels(outcome="completed").inc()
        _M_TENANT_REQUESTS.labels(tenant=p.tenant, outcome="completed").inc()
        p.ctx.finish("completed", now)
        self._observe_flight(p, error=False)
        p.fut.set_result(out)

    def _fail(self, p: _Pending, e: Exception) -> None:
        now = time.monotonic()
        with self._cond:
            self._record_latency(p, now)
            self._stats["failed"] += 1
            ten = self._tenants.get(p.tenant)
            if ten is not None:
                ten.failed += 1
        _M_REQUESTS.labels(outcome="failed").inc()
        _M_TENANT_REQUESTS.labels(tenant=p.tenant, outcome="failed").inc()
        p.ctx.finish("failed", now, error=e)
        self._observe_flight(p, error=True)
        if isinstance(e, SortOverflowError):
            # the capacity ladder is exhausted — the one failure mode
            # the paper's balance argument says should never happen on
            # realistic distributions, so it always leaves evidence
            self._flight_anomaly("terminal_overflow", {
                "trace_id": p.ctx.trace_id,
                "n": p.ctx.n,
                "error": repr(e),
            })
        p.fut.set_exception(e)

    def _observe_flight(self, p: _Pending, *, error: bool) -> None:
        """Terminal accounting shared by resolve/fail: the request
        summary lands in the flight ring, the SLO judges the latency,
        and a deadline miss beyond ``deadline_miss_factor`` flush
        windows triggers an incident snapshot."""
        ctx = p.ctx
        self._flight.record_request(ctx.summary())
        total_ms = ctx.total_ms
        if self._slo is not None:
            self._slo.observe(total_ms, error=error)
        miss_ms = self.deadline_miss_factor * self.max_delay * 1e3
        if not error and total_ms is not None and total_ms > miss_ms:
            self._flight_anomaly("deadline_miss", {
                "trace_id": ctx.trace_id,
                "total_ms": total_ms,
                "threshold_ms": miss_ms,
                "max_delay_ms": self.max_delay * 1e3,
            })
