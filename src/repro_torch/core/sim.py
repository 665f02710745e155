"""Virtual-processor simulator of the PGX.D distributed sort.

Counterpart of ``repro/core/sim.py``. ``x`` has shape (p, n_local): axis
0 is the processor axis, and the exchange is an explicit gather and
transpose. On one GPU this grid is the shape of the whole sort. The six
paper steps map 1:1 onto the code below.

Given a ``trace`` (``obs.tracing.Trace``), each sort records the phase
spans of ``repro``'s phased variants (``sample_sort_sim_phased[_kv]``):
local_sort, splitter (with ``overflowed``), exchange and merge (with
``per_proc`` and ``imbalance``), fencing at each boundary. The port runs
eagerly, so the same step functions run either way and the output is the
same bits; an untraced sort makes no extra host read or wait.

The keys-only sort also takes a batch of independent sorts, x of shape
(B, p, n), where ``repro`` vmapped its program (the serving flush,
``SortLibrary.sort_many``): the batch folds into the rows, so B sorts
launch each kernel as often as one sort does (one row sort over B*p*n/tile
tiles, one merge per round over all rows), and each sort keeps its own
samples, splitters, bounds, counts and overflow flag.
``sample_sort_sim_flat`` is the serving variant, with the decode fused in.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import keyenc
from repro_torch.core import merge as merge_lib
from repro_torch.core import splitters as spl
from repro_torch.core.local_sort import local_sort, local_sort_kv
from repro_torch.kernels import ops as kops
from repro_torch.obs.tracing import maybe_span as _span


class SortResult(NamedTuple):
    """Sort output in the global view (leading axis = processor; a batch
    of sorts adds its batch axis in front of each field).

    values:      (p, p2 * cap) sorted per processor, sentinel padded.
    counts:      (p,) int32 valid prefix length per processor.
    overflowed:  bool scalar, True iff a static bucket overflowed (the
                 exchange then dropped data and the result is invalid);
                 a Python bool in a traced sort, which reads it in its
                 splitter span; (B,) for a batch, one flag per sort.
    send_counts: (p, p) int32 bucket sizes per (source, destination).
    """

    values: torch.Tensor
    counts: torch.Tensor
    overflowed: torch.Tensor
    send_counts: torch.Tensor


class SortKVResult(NamedTuple):
    keys: torch.Tensor
    values: torch.Tensor
    counts: torch.Tensor
    overflowed: torch.Tensor
    send_counts: torch.Tensor


def _bounds_all(xs, splitters, investigator: bool, search) -> torch.Tensor:
    fn = spl.investigator_bounds if investigator else spl.naive_bounds
    return fn(xs, splitters, search)  # (..., p, p+1)


def _split(xs, config: spl.SortConfig, investigator: bool, key_bytes: int,
           nan_keys: bool = False):
    """Steps 2-4: samples, splitters, bounds, and the overflow flag, for
    each sort of a batch (..., p, n)."""
    p, n = xs.shape[-2:]
    search = kops.rank_functions(nan_keys)[0]
    s = config.num_samples(p, n, key_bytes=key_bytes)
    samples = spl.regular_sample(xs, s)  # "send to master": (..., p, s)
    splitters = spl.select_splitters(samples.flatten(-2), p, nan_keys)
    bounds = _bounds_all(xs, splitters, investigator, search)
    send_counts = bounds[..., 1:] - bounds[..., :-1]
    overflowed = (send_counts > config.capacity(p, n)).flatten(-2).any(-1)
    return bounds, send_counts, overflowed


def _gather_buckets(xs: torch.Tensor, bounds: torch.Tensor, cap: int) -> torch.Tensor:
    """Cut the p destination buckets out of every sorted shard at once.

    Bucket (i, j) is ``xs[..., i, bounds[..., i, j] + arange(cap)]`` with
    positions at or past its count set to the sentinel: (..., p_src,
    p_dst, cap); p_dst is read off ``bounds`` (..., p_src, p_dst + 1), so a
    mesh rank cuts its one shard (1, n) into its p buckets. A kept
    position never passes the end of its shard (start + count <= n), so
    clamping the index only touches positions that are masked anyway."""
    n, p = xs.shape[-1], bounds.shape[-1] - 1
    fill = kops.sentinel_for(xs.dtype)
    start = bounds[..., :-1].to(torch.int64)
    count = (bounds[..., 1:] - bounds[..., :-1])[..., None]
    pos = torch.arange(cap, device=xs.device)
    idx = (start[..., None] + pos).clamp_(max=n - 1).flatten(-2)
    seg = torch.gather(xs, -1, idx).unflatten(-1, (p, cap))
    return seg.masked_fill_(pos >= count, fill)


def _split_span(trace, xs, config, investigator, key_bytes, nan_keys=False):
    """Steps 2-4 as the ``splitter`` phase."""
    with _span(trace, "splitter") as sp:
        bounds, send_counts, overflowed = sp.fence(
            _split(xs, config, investigator, key_bytes, nan_keys))
        if trace is not None:
            # a traced sort reads the flag here, and the ladder reads it from here
            overflowed = bool(overflowed)
            sp.set(overflowed=overflowed)
    return bounds, send_counts, overflowed


def sample_sort_sim(x: torch.Tensor, config: spl.SortConfig = spl.SortConfig(), *,
                    investigator: bool = True, nan_keys: bool = False,
                    trace=None) -> SortResult:
    """PGX.D sample sort over virtual processors. x: (p, n_local), or a
    batch (B, p, n_local) of independent sorts (module docstring).

    ``nan_keys``: the float keys hold a NaN (the front end's probe; for a
    batch, any of its sorts). The splitter search and the wide-row merges
    then follow ``repro``'s probes and its scatter's collision rule
    (``ops.rank_functions``), so that the result equals ``repro``'s on such
    keys too, on either device; without a NaN the two searches and merges
    agree, so the sorts of a batch that hold none get the same bits.
    ``trace``: record the four phase spans (see the module docstring)."""
    p, n = x.shape[-2:]
    cap = config.capacity(p, n)
    wide_merge = kops.rank_functions(nan_keys)[1]

    # (1) local sort: Fig. 2 tile sort + balanced merge tree, every shard
    with _span(trace, "local_sort") as sp:
        xs = sp.fence(local_sort(x, tile=config.tile, use_pallas=config.use_pallas,
                                 wide_merge=wide_merge))
        sp.counts([n] * p)

    # (2) regular sampling; (3) splitters; (4) investigator bounds
    bounds, send_counts, overflowed = _split_span(trace, xs, config, investigator,
                                                  x.element_size(), nan_keys)

    # (5) exchange: static-capacity buckets, transpose = all_to_all
    with _span(trace, "exchange") as sp:
        recv = _gather_buckets(xs, bounds, cap).transpose(-3, -2)  # (..., p_dst, p_src, cap)
        counts = sp.fence(send_counts.sum(dim=-2, dtype=torch.int32))  # (..., p_dst)
        sp.counts(counts)

    # (6) balanced pairwise merge of the received runs
    with _span(trace, "merge") as sp:
        merged = sp.fence(merge_lib.merge_padded_runs(recv, use_pallas=config.use_pallas,
                                                      wide_merge=wide_merge))
        sp.counts(counts)
    return SortResult(merged, counts, overflowed, send_counts)


def sample_sort_sim_kv(keys: torch.Tensor, values: torch.Tensor,
                       config: spl.SortConfig = spl.SortConfig(), *,
                       investigator: bool = True, trace=None) -> SortKVResult:
    """Key/value variant: values ride along (provenance, user payloads).

    Exactly stable when ``values`` are globally unique, processor-then-
    position increasing indices (the provenance payload)."""
    p, n = keys.shape
    cap = config.capacity(p, n)

    with _span(trace, "local_sort") as sp:
        ks, vs = sp.fence(local_sort_kv(keys, values, tile=config.tile,
                                        use_pallas=config.use_pallas))
        sp.counts([n] * p)
    bounds, send_counts, overflowed = _split_span(trace, ks, config, investigator,
                                                  keys.element_size())

    with _span(trace, "exchange") as sp:
        recv_k = _gather_buckets(ks, bounds, cap).transpose(0, 1)
        recv_v = _gather_buckets(vs, bounds, cap).transpose(0, 1)
        counts = sp.fence(send_counts.sum(dim=0, dtype=torch.int32))
        sp.counts(counts)

    with _span(trace, "merge") as sp:
        mk, mv = sp.fence(merge_lib.merge_padded_runs_kv(recv_k, recv_v,
                                                         use_pallas=config.use_pallas))
        sp.counts(counts)
    return SortKVResult(mk, mv, counts, overflowed, send_counts)


class FlatSortResult(NamedTuple):
    """``sample_sort_sim_flat`` output, with the decode fused in.

    flat: (..., p * n_local) globally sorted, front-compacted elements:
      every staged element (sentinel pads included) in its final place,
      so a request's answer is a slice. For ``descending=True`` the flip
      is undone; for a ``packspec`` it is the tuple of unpacked columns.
    counts / overflowed / send_counts: as in ``SortResult``.
    """

    flat: Any
    counts: torch.Tensor
    overflowed: torch.Tensor
    send_counts: torch.Tensor


def sample_sort_sim_flat(x: torch.Tensor, config: spl.SortConfig = spl.SortConfig(), *,
                         investigator: bool = True, descending: bool = False,
                         packspec=None, nan_keys: bool = False) -> FlatSortResult:
    """The sort with the device decode fused in: the serving flush's unit
    of work, as ``repro``'s ``sample_sort_sim_flat``.

    ``x`` is the staged (p, n) grid (real elements and sentinel pads) or a
    batch (B, p, n) of them. Descending grids arrive raw, padded with the
    flipped sentinel, and are flipped here (``keyenc.flip``: the CPU's
    ``-x`` bit for bit for floats), sorted, compacted and flipped back.
    ``packspec``: ``x`` holds packed ascending multi-key keys (int32 or
    int64, padded with the plain sentinel), unpacked into the columns
    after compaction. ``nan_keys``: as in ``sample_sort_sim``."""
    if descending:
        x = keyenc.flip(x)
    res = sample_sort_sim(x, config, investigator=investigator, nan_keys=nan_keys)
    p, n = x.shape[-2:]
    flat = keyenc.compact_rows(res.values, res.counts, p * n)
    if descending:
        flat = keyenc.flip(flat)
    if packspec is not None:
        flat = keyenc.unpack_fields(flat, packspec)
    return FlatSortResult(flat, res.counts, res.overflowed, res.send_counts)
