"""Run generation: pass 1 of the external sort (paper steps 1-2 at dataset
scale).

Counterpart of ``repro/stream/runs.py``. The dataset, which stays where
the caller put it (host arrays, CPU tensors, or an iterator of them), is
cut into device-sized chunks; each chunk is sorted with the
virtual-processor sample sort (``sim.sample_sort_sim``) and copied back to
the host, compacted, as a *run*.

On the card the copies overlap the sorts, as ``repro`` overlaps them
through jax's asynchronous dispatch (``_Stager``):

  * a chunk is copied into one of two pinned host buffers and sent to the
    device on a copy stream; the sort stream waits on the copy's event,
    so the copy of chunk i+1 runs while chunk i sorts;
  * a pinned buffer is rewritten only after its last copy's event has
    completed, and its device buffer only after the sort stream's event
    that the chunk it held is finished with it;
  * the overflow read of chunk i (``finalize``) comes after chunk i+1's
    copy is issued; the run then comes back in one copy of the compacted
    chunk (``keyenc.compact_rows``) into pinned memory.

On the CPU (``device="cpu"``) the chunks are plain CPU tensors: no pinned
memory, no side stream.

Keys travel encoded: a chunk is mapped to its signed lane
(``keyenc.to_lane``, for uint16 and uint32) and, for a descending stream,
flipped (``keyenc.flip``) on the device right after the copy, padded with
the lane's sentinel; runs hold the encoded keys, and pass 3 decodes each
output chunk. Payload values travel in their lanes too; the argsort
payload (``values=range(n)``) is made on the device chunk by chunk.

A chunk whose buckets overflowed is sorted again up the capacity ladder
(``overflow.retry_overflowed``), never dropped. A keys-only float chunk
that holds a NaN sorts with ``repro``'s probes (``ops.rank_functions``),
decided on the host for host chunks; its run carries the flag to passes 2
and 3, whose searches and wide merges must then follow the same probes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import torch

from repro_torch import device as _device
from repro_torch import tune as _tune
from repro_torch.core import keyenc, overflow, planner, sim
from repro_torch.core.splitters import SortConfig
from repro_torch.kernels import ops as kops
from repro_torch.obs.profiling import annotate as _annotate


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs of the out-of-core pipeline (``repro``'s fields and defaults).

    chunk_elems: per-chunk element capacity, the device-sized unit. A run
      never exceeds it, and pass-3 merge memory is bounded by about one
      bucket, which the splitters balance to this size.
    n_procs: virtual processors of each in-core chunk sort.
    sort: the in-core SortConfig.
    max_doublings / growth: the capacity ladder of a chunk sort; overflow
      past the ladder always raises (a partially exchanged run cannot be
      returned).
    n_buckets: range buckets of pass 2; None = ceil(total / chunk_elems).
    out_chunk_elems: granularity of the sorted output stream; None =
      chunk_elems.
    x64: the request's x64 mode (``SortPlan.x64``), against which every
      chunk's dtype is checked at staging, the first point an iterator's
      dtype is known; None reads the ambient switch (``core.x64``).
    """

    chunk_elems: int = 1 << 16
    n_procs: int = 8
    sort: SortConfig = SortConfig()
    max_doublings: int = 3
    growth: float = 2.0
    n_buckets: int | None = None
    out_chunk_elems: int | None = None
    x64: bool | None = None


@dataclasses.dataclass
class Run:
    """One sorted, chunk-sized fragment of the dataset, held on the host.

    keys: the encoded keys (signed lane, flipped for a descending stream),
      a CPU tensor; ``values`` (in their lane, same order) is None for
      keys-only sorts. ``retries``: capacity-ladder steps of this chunk's
      sort. ``dtype`` / ``value_dtype``: the caller's dtypes, which pass 3
      decodes to. ``nan_keys``: the chunk held a NaN key. ``home``: (keys
      block, values block or None, offset), the host buffers ``keys`` and
      ``values`` are slices of (None: they are their own).
    """

    keys: torch.Tensor
    values: torch.Tensor | None = None
    retries: int = 0
    dtype: torch.dtype | None = None
    value_dtype: torch.dtype | None = None
    nan_keys: bool = False
    home: tuple | None = None

    def __len__(self) -> int:
        return int(self.keys.shape[0])


def iter_chunks(data, chunk_elems: int) -> Iterator:
    """Re-chunk an array (numpy array or tensor, left where it is), an
    iterator of arrays, or a ``range`` (the argsort payload) into
    <= chunk_elems pieces; iterator pieces are split and coalesced."""
    if isinstance(data, range):
        for i in range(0, len(data), chunk_elems):
            yield data[i:i + chunk_elems]
        return
    if hasattr(data, "dtype"):
        flat = planner.as_tensor(data).reshape(-1)
        for i in range(0, flat.shape[0], chunk_elems):
            yield flat[i:i + chunk_elems]
        return
    buf: list[torch.Tensor] = []
    have = 0
    for piece in data:
        piece = planner.as_tensor(piece).reshape(-1)
        while piece.numel():
            take = min(piece.numel(), chunk_elems - have)
            buf.append(piece[:take])
            have += take
            piece = piece[take:]
            if have == chunk_elems:
                yield torch.cat(buf) if len(buf) > 1 else buf[0]
                buf, have = [], 0
    if have:
        yield torch.cat(buf) if len(buf) > 1 else buf[0]


class _Stager:
    """Moves chunks to the sort's device, double-buffered on the card.

    Each slot (two per array: keys and values) owns a pinned host buffer
    and a device buffer of chunk capacity, an event recorded on the copy
    stream when its copy is issued, and one recorded on the sort stream
    when the chunk it holds is finished with (``release``)."""

    def __init__(self, device: torch.device, capacity: int):
        self.device = device
        self.capacity = capacity
        self.slots: dict = {}
        if device.type == "cuda":
            self.copy_stream = torch.cuda.Stream(device)

    def _slot(self, key, dtype):
        slot = self.slots.get(key)
        if slot is None or slot[0].dtype != dtype:
            slot = (torch.empty(self.capacity, dtype=dtype, pin_memory=True),
                    torch.empty(self.capacity, dtype=dtype, device=self.device),
                    torch.cuda.Event(), torch.cuda.Event())
            self.slots[key] = slot
        return slot

    def stage(self, chunk, key) -> torch.Tensor:
        """``chunk`` on the device, ready for the sort stream. A ``range``
        becomes an int32 iota made there."""
        if isinstance(chunk, range):
            return torch.arange(chunk.start, chunk.stop, dtype=torch.int32, device=self.device)
        if self.device.type != "cuda" or chunk.is_cuda:
            return chunk.to(self.device)
        pinned, buf, copied, freed = self._slot(key, chunk.dtype)
        m = chunk.numel()
        copied.synchronize()  # the pinned buffer's last copy has been read
        pinned[:m].copy_(chunk)
        self.copy_stream.wait_event(freed)  # the device buffer's last chunk is done
        with torch.cuda.stream(self.copy_stream):
            buf[:m].copy_(pinned[:m], non_blocking=True)
            copied.record()
        torch.cuda.current_stream(self.device).wait_event(copied)
        return buf[:m]

    def release(self, key) -> None:
        """The sort stream is finished with the chunk in slot ``key``
        (recorded there; the copy stream waits on it before reuse)."""
        slot = self.slots.get(key)
        if slot is not None:
            slot[3].record(torch.cuda.current_stream(self.device))


_BLOCK_ELEMS = 1 << 26  # 4-byte elements of a full host block of runs (256 MiB)


class _RunStore:
    """Host memory for the runs of one pass 1: each run's keys (and
    values) are copied into the next free slice of the current block,
    pinned on the card, without a wait (valid once the sort stream reaches
    the copy). A block holds ``_BLOCK_ELEMS`` elements (half as many of
    8-byte keys or values, so that a pinned block stays at 256 MiB), or
    what is left of a known total if that is less; for an iterator, whose
    total is not known, each block is twice the last, from one chunk up to
    that size. A run never straddles two blocks."""

    def __init__(self, total: int | None, pinned: bool):
        self.left, self.pinned = total, pinned
        self.blocks: tuple = ()
        self.used = 0

    def put(self, keys: torch.Tensor, values: torch.Tensor | None):
        """(keys slice, values slice or None, home) of the stored run."""
        m = keys.shape[0]
        if (not self.blocks or self.used + m > self.blocks[0].shape[0]
                or self.blocks[0].dtype != keys.dtype):
            grow = self.left if self.left is not None else 2 * (
                self.blocks[0].shape[0] if self.blocks else 0)
            widest = max(x.element_size() for x in (keys, values) if x is not None)
            cap = max(m, min(_BLOCK_ELEMS * 4 // max(4, widest), grow))
            self.blocks = tuple(None if x is None else
                                torch.empty(cap, dtype=x.dtype, pin_memory=self.pinned)
                                for x in (keys, values))
            self.used = 0
        off, self.used = self.used, self.used + m
        if self.left is not None:
            self.left -= m
        kb, vb = self.blocks
        return (kb[off:off + m].copy_(keys, non_blocking=True),
                None if vb is None else vb[off:off + m].copy_(values, non_blocking=True),
                (kb, vb, off))


def _known_total(data) -> int | None:
    """The element count of an array or ``range`` (None for an iterator)."""
    if isinstance(data, range):
        return len(data)
    return math.prod(data.shape) if hasattr(data, "dtype") else None


def _grid(x: torch.Tensor, p: int, per: int) -> torch.Tensor:
    """The (p, per) staging grid of an encoded chunk, sentinel padded
    (``planner.pad_grid``: rows evenly filled)."""
    if x.shape[0] == p * per:
        return x.reshape(p, per)
    return planner.pad_grid(x, p, per, kops.sentinel_for(x.dtype))


def generate_runs(data, cfg: StreamConfig = StreamConfig(), values=None, *,
                  investigator: bool = True, descending: bool = False,
                  device=None) -> list[Run]:
    """Pass 1: cut ``data`` into chunks, sort each on ``device``, return
    the runs (host-resident).

    ``values`` (optional payload: an array, an iterator, or ``range(n)``
    for the argsort index) must chunk identically to ``data``.
    ``descending=True`` flips each chunk on the device after its copy, so
    the runs are flip-encoded ascending (pass 3 decodes them)."""
    dev = _device.resolve(device)
    p, per = cfg.n_procs, -(-cfg.chunk_elems // cfg.n_procs)
    key_chunks = iter_chunks(data, p * per)
    val_chunks = iter_chunks(values, p * per) if values is not None else None
    stager = _Stager(dev, p * per)
    store = _RunStore(_known_total(data), pinned=dev.type == "cuda")
    policy = overflow.OverflowPolicy(max_doublings=cfg.max_doublings, growth=cfg.growth)

    def dispatch(xk, xv, sort_cfg, nan):
        if xv is None:
            return sim.sample_sort_sim(xk, sort_cfg, investigator=investigator, nan_keys=nan)
        return sim.sample_sort_sim_kv(xk, xv, sort_cfg, investigator=investigator)

    def finalize(state) -> Run:
        xk, xv, res, m, slot, dtypes, nan = state
        retries = 0
        if bool(res.overflowed):  # the chunk's one host read
            # with a tuner ambient the ladder starts at the capacity the
            # chunk's own send_counts ask for; the cold ladder is unchanged
            measured = (overflow.measured_capacity_need(p, per)
                        if _tune.current() is not None else None)
            res, _, retries = overflow.retry_overflowed(
                lambda c: dispatch(xk, xv, c, nan), cfg.sort, policy, last=res,
                measured=measured)
        if xv is None:
            keys, _, home = store.put(keyenc.compact_rows(res.values, res.counts, m), None)
            run = Run(keys, retries=retries, dtype=dtypes[0], nan_keys=nan, home=home)
        else:
            keys, vals, home = store.put(keyenc.compact_rows(res.keys, res.counts, m),
                                         keyenc.compact_rows(res.values, res.counts, m))
            run = Run(keys, vals, retries=retries, dtype=dtypes[0], value_dtype=dtypes[1],
                      home=home)
        stager.release(("keys", slot))
        stager.release(("values", slot))
        return run

    runs: list[Run] = []
    inflight = None
    for i, chunk in enumerate(key_chunks):
        m = int(chunk.shape[0])
        planner.check_key_dtype(chunk.dtype, what="stream chunk keys", x64=cfg.x64)
        nan = (values is None and chunk.dtype.is_floating_point
               and bool(chunk.isnan().any()))
        slot = i % 2
        with _annotate("repro.stream.stage_chunk"):
            # the copy of this chunk goes out while the previous chunk sorts
            xk = keyenc.encode(keyenc.to_lane(stager.stage(chunk, ("keys", slot))), descending)
            xk = _grid(xk, p, per)
            xv, dtypes = None, (chunk.dtype, None)
            if val_chunks is not None:
                vchunk = next(val_chunks, None)
                if vchunk is None or len(vchunk) != m:
                    raise ValueError("values must chunk identically to keys")
                if not isinstance(vchunk, range):
                    planner.check_key_dtype(vchunk.dtype, what="stream chunk values",
                                            x64=cfg.x64)
                xv = keyenc.to_lane(stager.stage(vchunk, ("values", slot)))
                xv = _grid(xv, p, per)
                dtypes = (chunk.dtype, xv.dtype if isinstance(vchunk, range) else vchunk.dtype)
        if inflight is not None:
            runs.append(finalize(inflight))  # waits on the previous chunk's sort
        inflight = (xk, xv, dispatch(xk, xv, cfg.sort, nan), m, slot, dtypes, nan)
    if inflight is not None:
        runs.append(finalize(inflight))
    if val_chunks is not None and next(val_chunks, None) is not None:
        raise ValueError("values must chunk identically to keys")
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()  # the runs' copies have landed
    return runs
