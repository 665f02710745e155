"""Sort-service front end: shape-bucketed batched flushes.

Counterpart of ``repro/stream/service.py``. Concurrent sort requests of
any length are padded up to power-of-two *shape buckets*; the requests of
one bucket are stacked into a (B, p, per) batch and sorted as ONE batched
sort (``sim.sample_sort_sim_flat``), with the decode fused in: compaction,
the flip of descending buckets and the unpack of packed multi-key
buckets all run on the device before the one copy of the decoded (B,
p*per) output to the host. Where ``repro`` vmapped a jitted program, the
port folds the batch into the rows of its kernels, so a flush of B
requests launches each bitonic kernel as often as one sort does. The
``ProgramCache`` keeps ``repro``'s key and accounting, but compiles
nothing: its values are the batched sim functions with their options bound.

Staging: the batch size is padded to a power of two (part of the bucket
key, and of the flight record's ``padded_batch``); every request's
elements are spread evenly over the grid's rows (``planner.pad_grid``).
Requests held on the host are staged into one pinned buffer and copied to
the device once per flush; a request already on the flush's device is
staged there. Results are CPU tensors, as the stream backend's.

Overflow is per request: only the requests whose buckets overflowed are
retried, each alone through the unified capacity ladder
(``core.overflow``), the batched attempt counting as the failed first
rung. A request that still overflows fails alone; ``SortServiceError``
carries the completed results beside the failures.

NaN keys: a flush whose float batch holds a NaN anywhere runs every
request with ``repro``'s searches (``ops.rank_functions(True)``), which
give the NaN-free requests the same bits as the plain ones.

``SortService`` is the synchronous front end (``submit`` then ``flush``);
``repro_torch.serve.sortd.SortServer`` is the asynchronous one. Both run
their flushes through ``FlushEngine``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import keyenc, planner, sim
from repro_torch.core.overflow import OverflowPolicy, SortOverflowError, retry_overflowed
from repro_torch.core.splitters import SortConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import _next_pow2
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.profiling import annotate as _annotate

_M_CACHE_BUILDS = obs_metrics.counter(
    "repro_program_cache_builds_total",
    "ProgramCache misses: a new program key (the port binds a batched sim "
    "function there and compiles nothing).",
)
_M_CACHE_HITS = obs_metrics.counter(
    "repro_program_cache_hits_total",
    "ProgramCache lookups served by a key seen before.",
)
_M_COALESCE_SIZE = obs_metrics.histogram(
    "repro_flush_coalesce_size",
    "Requests coalesced into one batched flush, by program kind.",
    labels=("kind",),  # plain|descending|packed
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, float("inf")),
)


class ProgramCache:
    """Batched sort callables keyed by ``repro``'s program key: (batch, p,
    per, dtype, key width, config, investigator, flat, descending,
    packspec). A flat program is ``sim.sample_sort_sim_flat`` (the decode
    fused in), else ``sim.sample_sort_sim``; each takes the (batch, p,
    per) grid and ``nan_keys``. Where ``repro`` compiles a program per
    key, the port compiles nothing (it runs eagerly and launches its
    kernels directly): a value is a ``functools.partial``. The class stays
    for ``repro``'s accounting, which the flight records and the
    ``repro_program_cache_*`` metrics carry: ``stats`` counts
    ``programs`` (new keys) and ``hits`` as ``repro``'s does. Used by
    ``FlushEngine`` and ``SortLibrary.sort_many``."""

    def __init__(self, stats: dict | None = None):
        self.programs: dict = {}
        self.stats = stats if stats is not None else {"programs": 0, "hits": 0}
        self.stats.setdefault("programs", 0)
        self.stats.setdefault("hits", 0)

    def get(self, batch: int, p: int, per: int, dtype: torch.dtype,
            config: SortConfig, investigator: bool, *,
            flat: bool = False, descending: bool = False, packspec=None):
        key = (batch, p, per, keyenc.dtype_name(dtype), 8 * dtype.itemsize, config,
               investigator, flat, descending, packspec)
        fn = self.programs.get(key)
        if fn is None:
            if flat:
                fn = functools.partial(sim.sample_sort_sim_flat, config=config,
                                       investigator=investigator, descending=descending,
                                       packspec=packspec)
            else:
                fn = functools.partial(sim.sample_sort_sim, config=config,
                                       investigator=investigator)
            self.programs[key] = fn
            self.stats["programs"] += 1
            _M_CACHE_BUILDS.inc()
        else:
            self.stats["hits"] += 1
            _M_CACHE_HITS.inc()
        return fn


@dataclasses.dataclass
class SortRequest:
    rid: int
    data: torch.Tensor  # flat, any admitted key dtype, on any device
    trace_id: str | None = None  # obs.flight identity, minted at submit


def _lane_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a key travels as (uint16/32/64 as their signed lanes)."""
    return keyenc._LANES.get(dtype, (dtype,))[0]


class FlushEngine:
    """The flush core of the sync ``SortService`` and the async
    ``repro_torch.serve.sortd.SortServer``.

    Owns the ``ProgramCache`` and the per-request overflow ladder; callers
    own queueing, admission and error policy. ``run_group`` runs one shape
    bucket's requests (sliced into ``max_batch``-sized flushes, in list
    order) and returns, per request, ``(sorted CPU tensor | tuple of
    columns | terminal SortOverflowError, ladder_steps)``.

    device: where the flushes run; None means "cuda" (the port's device
    rule: without a card it raises, and ``device="cpu"`` must be asked
    for)."""

    def __init__(self, *, config: SortConfig = SortConfig(), n_procs: int = 8,
                 investigator: bool = True, max_doublings: int = 3,
                 growth: float = 2.0, max_batch: int = 64,
                 stats: dict | None = None, stats_lock=None, device=None):
        dev = _device.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev  # with its index: staging compares tensors' devices to it
        self.config = config
        self.n_procs = n_procs
        self.investigator = investigator
        self.max_doublings = max_doublings
        self.growth = growth
        self.max_batch = max_batch
        self.stats = stats if stats is not None else {}
        # "retries" may have a second writer (the async server's direct
        # workers add their ladder steps under its lock)
        self._stats_lock = stats_lock if stats_lock is not None else contextlib.nullcontext()
        for k in ("programs", "hits", "batches", "retries"):
            self.stats.setdefault(k, 0)
        self.cache = ProgramCache(self.stats)

    @property
    def policy(self) -> OverflowPolicy:
        return OverflowPolicy(max_doublings=self.max_doublings, growth=self.growth)

    def bucket_elems(self, n: int) -> int:
        """Pad target: next power of two, at least one element per proc."""
        return _next_pow2(max(n, self.n_procs))

    def bucket_key(self, data: torch.Tensor) -> tuple:
        """Requests with equal keys may share one flush; the key width is
        explicit, so 32- and 64-bit traffic never share one."""
        return (self.bucket_elems(data.numel()), keyenc.dtype_name(data.dtype),
                8 * data.dtype.itemsize)

    @staticmethod
    def _fill(dtype: torch.dtype, descending: bool):
        """Staging sentinel in the key's lane: pads must sort to the tail
        of the encoded space, so descending buckets stage the flipped
        sentinel, which the flush's flip maps back onto it."""
        lane = _lane_dtype(dtype)
        fill = torch.tensor([kops.sentinel_for(lane)], dtype=lane)
        return (keyenc.flip(fill) if descending else fill).item()

    def run_group(self, datas: list, *, descending: bool = False, packspec=None,
                  ctxs: list | None = None) -> list[tuple]:
        """Run one shape bucket's flat tensors; per entry, ``(result |
        terminal exception, ladder_steps)``. Descending buckets arrive raw;
        ``packspec`` buckets arrive as the packed ascending keys and each
        result is the tuple of columns. ``ctxs`` (parallel to ``datas``):
        the requests' ``obs.flight.RequestContext``s, which each flush
        links to its one flush record. Entries run in list order, sliced
        into ``max_batch``-sized flushes: a scheduling policy orders
        ``datas`` before calling."""
        elems = self.bucket_elems(datas[0].numel())
        out: list = []
        for i in range(0, len(datas), self.max_batch):
            out.extend(self._run_batch(datas[i:i + self.max_batch], elems, descending,
                                       packspec, ctxs[i:i + self.max_batch] if ctxs else None))
        return out

    def _stage(self, datas: list, b: int, p: int, per: int, fill) -> torch.Tensor:
        """The (b, p, per) batch of encoded lanes on the flush's device:
        host requests through one pinned buffer and one copy, requests
        already on the device staged there; batch rows past the requests
        hold the sentinel."""
        lane = _lane_dtype(datas[0].dtype)
        dev = self.device
        on_dev = [d.device == dev for d in datas]
        if all(on_dev):
            batch = torch.full((b, p, per), fill, dtype=lane, device=dev)
        else:
            grid = torch.full((b, p, per), fill, dtype=lane, pin_memory=dev.type == "cuda")
            for i, d in enumerate(datas):
                if not on_dev[i]:
                    grid[i] = planner.pad_grid(keyenc.to_lane(d.reshape(-1).cpu()), p, per, fill)
            batch = grid.to(dev, non_blocking=True)
        for i, d in enumerate(datas):
            if on_dev[i]:
                batch[i] = planner.pad_grid(keyenc.to_lane(d.reshape(-1)), p, per, fill)
        return batch

    def _run_batch(self, datas: list, elems: int, descending: bool, packspec=None,
                   ctxs: list | None = None) -> list[tuple]:
        p = self.n_procs
        per = -(-elems // p)
        dtype = datas[0].dtype
        fill = self._fill(dtype, descending)
        b = _next_pow2(len(datas))
        kind = "packed" if packspec is not None else "descending" if descending else "plain"
        fctx = obs_flight.FlushContext(
            kind=kind, batch=len(datas), padded_batch=b, elems=elems, dtype=dtype,
            trace_ids=[c.trace_id for c in ctxs] if ctxs else None,
        )
        t0 = time.monotonic()
        batch = self._stage(datas, b, p, per, fill)
        fn = self.cache.get(b, p, per, dtype, self.config, self.investigator,
                            flat=True, descending=descending, packspec=packspec)
        # one probe per flush: a NaN anywhere sends the whole batch down
        # repro's search, which is the plain one's bits without NaN
        nan_keys = batch.dtype.is_floating_point and bool(batch.isnan().any())
        t_staged = time.monotonic()
        with _annotate("repro.service.flush_batch"):
            res = fn(batch, nan_keys=nan_keys)
            # the flags' copy waits for the whole sort, queued before it
            overflowed = res.overflowed.cpu()
        t_sorted = time.monotonic()
        self.stats["batches"] += 1
        # ONE copy of the decoded (b, p * per) output to the host (one per
        # column of a packed bucket): a request's answer is a slice
        if packspec is not None:
            flat = tuple(c.cpu() for c in res.flat)
        else:
            flat = keyenc.from_lane(res.flat.cpu(), dtype)
        t_d2h = time.monotonic()
        fctx.phases = {
            "stage_ms": (t_staged - t0) * 1e3,
            "sort_ms": (t_sorted - t_staged) * 1e3,
            "d2h_ms": (t_d2h - t_sorted) * 1e3,
        }
        fctx.overflowed = int(overflowed[:len(datas)].sum())
        out: list = []
        for i, d in enumerate(datas):
            retries = 0
            if overflowed[i]:
                try:
                    entry = self._retry_one(batch[i], d.numel(), dtype, descending,
                                            packspec, nan_keys)
                except SortOverflowError as e:
                    entry = (e, self.max_doublings)
                retries = entry[1]
                out.append(entry)
            else:
                out.append((self._slice_result(flat, i, d.numel()), 0))
            if ctxs:
                ctxs[i].flush_id = fctx.flush_id
                ctxs[i].coalesced = len(datas)
                ctxs[i].retries = retries
                ctxs[i].phases = fctx.phases
            fctx.retries += retries
        _M_COALESCE_SIZE.labels(kind=kind).observe(len(datas))
        obs_flight.RECORDER.record_flush(fctx.summary())
        return out

    @staticmethod
    def _slice_result(flat, i: int, n: int):
        if isinstance(flat, tuple):
            return tuple(c[i, :n].clone() for c in flat)
        return flat[i, :n].clone()

    def _retry_one(self, grid: torch.Tensor, n: int, dtype: torch.dtype, descending: bool,
                   packspec, nan_keys: bool) -> tuple:
        """The capacity ladder for one overflowed request, on its staged
        (p, per) grid; the batched attempt at ``self.config`` was the
        failed first rung. Returns ``(result, ladder_steps_taken)``."""

        def on_retry(_cfg):
            with self._stats_lock:
                self.stats["retries"] += 1

        r, _cfg, steps = retry_overflowed(
            lambda cfg: sim.sample_sort_sim_flat(grid, cfg, investigator=self.investigator,
                                                 descending=descending, packspec=packspec,
                                                 nan_keys=nan_keys),
            self.config, self.policy, on_retry=on_retry,
        )
        if packspec is not None:
            return tuple(c[:n].cpu() for c in r.flat), steps
        return keyenc.from_lane(r.flat[:n].cpu(), dtype), steps


class SortServiceError(RuntimeError):
    """Some requests failed terminally. ``results`` holds the flush's
    completed sorts (rid -> tensor); ``errors`` the per-rid failures."""

    def __init__(self, msg: str, results: dict, errors: dict):
        super().__init__(msg)
        self.results = results
        self.errors = errors


@dataclasses.dataclass
class SortService:
    """Micro-batching sort service over the virtual-processor sample sort.

    max_batch: requests per flush (the batch is padded to a power of two,
      so batch sizes bucket too).
    device: where the flushes run; None means "cuda" (raises without a
      card; pass "cpu" to run on the CPU).
    """

    config: SortConfig = SortConfig()
    n_procs: int = 8
    investigator: bool = True
    max_doublings: int = 3
    max_batch: int = 64
    device: Any = None

    def __post_init__(self):
        self._queue: list[SortRequest] = []
        self._next_rid = 0
        self.stats = {"programs": 0, "hits": 0, "batches": 0, "retries": 0}
        self._engine = FlushEngine(
            config=self.config, n_procs=self.n_procs, investigator=self.investigator,
            max_doublings=self.max_doublings, max_batch=self.max_batch, stats=self.stats,
            device=self.device,
        )

    @property
    def policy(self) -> OverflowPolicy:
        return self._engine.policy

    def _bucket_elems(self, n: int) -> int:
        return self._engine.bucket_elems(n)

    def submit(self, data) -> int:
        """Enqueue a sort request (a tensor or numpy array, flattened);
        returns its rid. Each request gets a ``trace_id``."""
        t = planner.as_tensor(data).reshape(-1)
        planner.check_key_dtype(t.dtype)
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(SortRequest(rid, t, trace_id=obs_flight.new_trace_id()))
        return rid

    def flush(self) -> dict:
        """Run every queued request, batched by shape bucket. Every request
        runs even when one fails terminally: the ``SortServiceError``
        raised at the end carries the completed results."""
        groups: dict[tuple, list[SortRequest]] = {}
        for req in self._queue:
            groups.setdefault(self._engine.bucket_key(req.data), []).append(req)
        self._queue = []
        out: dict = {}
        errors: dict = {}
        for reqs in groups.values():
            now = time.monotonic()
            ctxs = [obs_flight.RequestContext(now, trace_id=r.trace_id, kind="coalesced",
                                              n=r.data.numel(), dtype=r.data.dtype,
                                              backend="sim")
                    for r in reqs]
            for c in ctxs:
                c.dispatched(now)  # sync service: no queue-wait to split
            results = self._engine.run_group([r.data for r in reqs], ctxs=ctxs)
            for req, ctx, (res, _retries) in zip(reqs, ctxs, results):
                if isinstance(res, Exception):
                    errors[req.rid] = RuntimeError(f"sort request rid={req.rid}: {res}")
                    ctx.finish("failed", error=res)
                else:
                    out[req.rid] = res
                    ctx.finish("completed")
                obs_flight.RECORDER.record_request(ctx.summary())
        if errors:
            rids = sorted(errors)
            raise SortServiceError(
                f"{len(errors)} sort request(s) failed terminally "
                f"(rids {rids}): {errors[rids[0]]}",
                out, errors,
            )
        return out

    def sort_many(self, arrays: Sequence) -> list:
        """Sort several independent arrays; same-bucket arrays share one
        flush."""
        rids = [self.submit(a) for a in arrays]
        done = self.flush()
        return [done[r] for r in rids]

    def sort(self, x):
        return self.sort_many([x])[0]
