"""``SortOutput``: the result type of ``repro_torch.sort``.

Counterpart of ``repro/core/result.py``. The sorted keys and payload are
tensors in the caller's dtypes: on the sort's device for the sim backend,
CPU tensors for the stream backend (whose output lives on the host, as
``repro``'s numpy output does) and for ``decode="host"``. The per-shard
diagnostics (``counts``, ``send_counts``) are small host numpy arrays, as
in ``repro``.

The views materialize lazily where the backend is lazy: a stream result
runs its passes when ``.keys`` / ``.values`` / ``.order()`` is first read,
or yields its sorted chunks through ``chunks()`` in bounded memory.
``provenance()``, ``searchsorted()`` and ``topk()`` answer as ``repro``'s
do (``core.topk``), with tensors on the keys' device: the sort's device,
or the CPU for the stream and for ``decode="host"``.

A mesh sort is SPMD (``planner._exec_mesh``): each rank's output holds
one ``Block`` of the global result in ``keys`` / ``values``, with the
global ``counts``, ``send_counts``, ``overflowed`` and ``meta.retries``
(the same on every rank) and ``meta.n`` the global length. The views
that need the whole result (``topk``, ``searchsorted``) refuse a block.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, NamedTuple

import numpy as np
import torch


@dataclasses.dataclass
class SortMeta:
    """Backend and plan metadata recorded on every SortOutput.

    config: the SortConfig actually used, after any capacity retries.
    retries: capacity-ladder steps taken by the overflow policy. The
      stream backend reports the sum of its per-chunk ladder steps here
      (filled in when pass 1 has run) and the breakdown on
      ``chunk_retries``.
    chunk_retries: stream backend only: ladder steps per pass-1 chunk, in
      chunk order (None elsewhere, and before the passes have run).
    order: "asc" | "desc", or a tuple with one flag per key.
    n_keys: key columns of the request (1 for a single key).
    n_local: per-processor row length when the input arrived in the
      (p, n_local) layout.
    dtype: the key dtype (the first column's for a multi-key sort); None
      only for iterator inputs, whose dtype is known once a chunk arrives.
    multikey: how a multi-key request ran, "packed" or "lsd"; None for a
      single key. ``plan.packspec`` holds a packed run's recipe.
    trace: the ``obs.tracing.Trace`` of this sort's phase spans when
      tracing was on (``SortLimits(trace=True)`` or an ambient
      ``obs.trace()``); None otherwise. A per-sort trace freezes when the
      output materializes.
    coalesced: set by the sort server (``repro_torch.serve.sortd``) on
      results that ran in a batched flush: how many requests shared it.
      None for ordinary sorts.
    trace_id / flush_id: the serve tier's request identity
      (``obs.flight``) and the flush that served it.
    t_start: the ``time.perf_counter()`` at dispatch of a lazy result
      while a tuner was ambient; the wall time is recorded
      (``record_tune``) when the output materializes.
    exchanges: a mesh tuple sort's indexed exchanges between the ranks,
      by kind (``{"take": n, "reblock": n}``: ``planner._mesh_take`` and
      ``_mesh_reblock``); None for every other sort.
    """

    backend: str
    plan: Any = None
    config: Any = None
    retries: int = 0
    n: int = 0
    want: str = "values"
    order: Any = "asc"
    n_keys: int = 1
    n_local: int | None = None
    dtype: Any = None
    chunk_retries: tuple | None = None
    multikey: str | None = None
    trace: Any = None
    coalesced: int | None = None
    trace_id: str | None = None
    flush_id: str | None = None
    t_start: float | None = None
    exchanges: dict | None = None


def record_tune(meta: SortMeta, t0: float) -> None:
    """Feed a completed sort's wall time since ``t0`` to the ambient
    tuner. The sort's CUDA device is fenced first: a sim result is device
    tensors whose work may still be queued, and the model must learn the
    time to run the sort, not to enqueue it."""
    dev = getattr(meta.plan, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    from repro_torch import tune

    tune.record_sort(meta, time.perf_counter() - t0)


class Block(NamedTuple):
    """Where a mesh rank's output sits in the global result: coordinate
    ``index`` of ``size`` along the sort axis, holding elements
    ``[start, stop)`` of the globally sorted keys (and payload)."""

    index: int
    size: int
    start: int
    stop: int


class SortOutput:
    """Sorted result, materialized on first read where the backend is lazy.

    keys:        flat sorted keys (a tensor), a tuple of them for a
                 multi-key sort.
    values:      payload in sorted-key order: the caller's values, or the
                 original flat indices when ``want="order"``; else None.
    counts:      per-shard (sim) or per-output-chunk (stream) sizes
                 (numpy), pads removed.
    send_counts: (p, p) per (source, destination) bucket sizes (numpy;
                 sim only).
    overflowed:  True iff a bucket overflowed (only when the policy does
                 not raise).
    raw:         the backend's padded global-view result (sim); a mesh
                 rank's own row (``sample_sort.ShardSortResult``).
    block:       a mesh rank's ``Block`` of the global result; None for
                 the other backends, whose output is the whole result.
    """

    def __init__(self, meta: SortMeta, *, keys=None, values=None, counts=None,
                 overflowed: bool = False, send_counts=None, raw: Any = None,
                 materialize: Callable | None = None,
                 chunks: Iterator | None = None, block: Block | None = None):
        self.meta = meta
        self.counts = counts
        self.overflowed = overflowed
        self.send_counts = send_counts
        self.raw = raw
        self.block = block
        self._keys = keys
        self._values = values
        self._materialize = materialize
        self._chunks = chunks
        self._chunks_consumed = False

    # ------------------------------------------------------ lazy views
    def _force(self) -> None:
        if self._materialize is not None:
            self._keys, self._values = self._materialize()
            self._materialize = None
        elif self._chunks_consumed:
            raise ValueError(
                "the stream result was already consumed via chunks(); "
                "keep the yielded chunks if you also need .keys"
            )
        elif self._chunks is not None:
            parts = list(self.chunks())
            if parts and isinstance(parts[0], tuple):
                # packed multi-key stream: chunks are column tuples
                self._keys = tuple(torch.cat(cols) for cols in zip(*parts))
            elif parts:
                self._keys = torch.cat(parts)
            else:
                # an iterator that never yielded a chunk has no dtype:
                # float32, as in repro
                self._keys = torch.empty(0, dtype=self.meta.dtype or torch.float32)
        if not self.meta.n and self._keys is not None:
            # iterator inputs have unknown n until materialization
            first = self._keys[0] if isinstance(self._keys, tuple) else self._keys
            self.meta.n = int(first.shape[0])
        if self.meta.trace is not None:
            # materialization completes the sort: publish the phase spans
            # and (for per-sort traces) freeze
            self.meta.trace.materialized()
        self._record_tune()

    def _record_tune(self) -> None:
        """Record the completed sort's wall time (dispatch to
        materialized) with the tuner; at most once per output, and only
        when ``execute_request`` stamped a start (a tuner was ambient)."""
        if self.meta.t_start is not None:
            t0, self.meta.t_start = self.meta.t_start, None
            record_tune(self.meta, t0)

    @property
    def keys(self):
        """Flat sorted keys, materialized on first access."""
        if self._keys is None:
            self._force()
        return self._keys

    @property
    def values(self):
        """Payload in sorted order; None for keys-only sorts."""
        if self._values is None and self._materialize is not None:
            self._force()
        return self._values

    def chunks(self) -> Iterator[torch.Tensor]:
        """Stream backend only: yield sorted chunks (CPU tensors) in
        bounded memory; single use, and consuming it is the
        materialization. Keys-only results stream in both orders; packed
        multi-key results yield per-chunk column tuples
        (``keyenc.unpack_chunk``)."""
        if self._chunks is None:
            if self._chunks_consumed:
                raise ValueError("chunks() was already consumed (single use)")
            if self.meta.backend == "stream":
                raise ValueError(
                    "this stream result does not stream: kv/argsort "
                    "results materialize on host (the value gather is "
                    "not bounded-memory), as do packed multi-key tuples "
                    'and descending results under the legacy decode='
                    '"host" plan — use .keys/.values'
                )
            raise ValueError(
                f"chunks() is only available on the stream backend "
                f"(this result came from {self.meta.backend!r})"
            )
        gen, self._chunks = self._chunks, None
        self._chunks_consumed = True
        sizes = []
        for c in gen:
            sizes.append(c[0].shape[0] if isinstance(c, tuple) else c.shape[0])
            yield c
        if self.counts is None:
            self.counts = np.asarray(sizes, np.int64)
        if not self.meta.n:
            self.meta.n = int(sum(sizes))
        if self.meta.trace is not None:
            # consuming the chunk stream is the materialization
            self.meta.trace.materialized()
        self._record_tune()

    def order(self) -> torch.Tensor:
        """The sorting permutation (``want="order"`` results)."""
        if self.meta.want != "order":
            raise ValueError('order() requires sort(..., want="order")')
        return self.values

    # ------------------------------------------------------ diagnostics
    def imbalance(self) -> float:
        """max/mean shard (or output-chunk) size; 1.0 is perfect balance
        (paper Table II). NaN when the backend recorded no counts (stream
        kv/argsort results materialize whole)."""
        if self.counts is None:
            return float("nan")
        counts = np.asarray(self.counts, np.float64)
        if counts.size == 0 or counts.sum() == 0:
            return 1.0
        return float(counts.max() / max(counts.mean(), 1e-12))

    def provenance(self):
        """Where each sorted element came from: with the (p, n_local)
        input layout, (processor, local index) tensors, the paper's
        provenance view; for flat inputs the flat origin index."""
        idx = self.order()
        if self.meta.n_local:
            n = self.meta.n_local
            return idx // n, idx % n
        return idx

    def _whole(self, view: str) -> None:
        if self.block is not None:
            raise ValueError(
                f"{view} needs the whole sorted result, and this mesh rank holds block "
                f"{self.block.index} of {self.block.size}; use core.topk.topk_shard for "
                f"a global top-k over the mesh")

    def searchsorted(self, queries, side: str = "left") -> torch.Tensor:
        """Global insertion ranks of ``queries`` (``np.searchsorted``'s,
        aware of descending results): ``core.topk.searchsorted_sorted``."""
        self._whole("searchsorted")
        keys = self.keys
        if isinstance(keys, tuple):
            raise ValueError("searchsorted is single-key only")
        from repro_torch.core.topk import searchsorted_sorted

        return searchsorted_sorted(keys, queries, side=side,
                                   descending=self.meta.order == "desc")

    def topk(self, k: int, largest: bool = True) -> torch.Tensor:
        """Top-k keys, best first, off the sorted result
        (``core.topk.topk_sorted``)."""
        self._whole("topk")
        keys = self.keys
        if isinstance(keys, tuple):
            raise ValueError("topk is single-key only")
        from repro_torch.core.topk import topk_sorted

        return topk_sorted(keys, k, largest=largest, descending=self.meta.order == "desc")

    def __len__(self) -> int:
        return self.meta.n

    def __repr__(self) -> str:
        state = "materialized" if self._keys is not None else "lazy"
        return (
            f"SortOutput(n={self.meta.n}, backend={self.meta.backend!r}, "
            f"want={self.meta.want!r}, order={self.meta.order!r}, "
            f"overflowed={self.overflowed}, {state})"
        )
