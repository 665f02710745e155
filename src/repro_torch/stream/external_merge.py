"""Streaming k-way merge: pass 3 of the external sort (paper step 6 at
dataset scale).

Counterpart of ``repro/stream/external_merge.py``. Each range bucket holds
k sorted segments, one per contributing run. They are gathered out of the
runs' host blocks, sentinel padded to a common power-of-two width, into a
(k, W) stack (pinned on the card) and merged on the device by the balanced
pairwise merge tree (``merge_padded_runs``), so the device holds
O(bucket) at a time. ``merge_segments[_kv]`` run the same bucket merge on
a list of segments, each its own block. The widths and sentinels are ``repro``'s: the
tree's rounds, and with them the tie order of a key/value merge, depend on
them. The merged bucket is decoded on the device (the inverse flip of a
descending stream, the unsigned lanes) and copied to the host once; the
output streams bucket by bucket as sorted CPU tensors (buckets are
disjoint ascending key ranges, so their concatenation is the sorted
dataset).

A bucket of one segment runs no merge: its keys are decoded on the host
(the host flip), and a key/value bucket still gets the device tie fix
(``_segment_stable_single``). When a run's chunk held a NaN key, the wide
merges follow ``repro``'s probes (``ops.rank_functions``), as pass 1 did.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import keyenc
from repro_torch.core import merge as merge_lib
from repro_torch.core.local_sort import segment_stable_kv
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import _next_pow2
from repro_torch.obs.tracing import maybe_span as _span
from repro_torch.stream.partition import Partition


def _decode(x: torch.Tensor, descending: bool, dtype) -> torch.Tensor:
    """Encoded keys back to the caller's dtype: the inverse flip, then the
    lane."""
    return keyenc.from_lane(keyenc.flip(x) if descending else x, dtype or x.dtype)


def _gather_padded(blocks, which: np.ndarray, starts: np.ndarray, lens: np.ndarray, fill,
                   pinned: bool) -> torch.Tensor:
    """The (k, W) stack of the segments ``blocks[which[i]][starts[i]:
    starts[i] + lens[i]]``, W the next power of two of the longest,
    sentinel padded; one host gather for each run of consecutive segments
    in one block, into pinned memory when ``pinned``."""
    k, width = lens.size, _next_pow2(int(lens.max()))
    out = torch.empty((k, width), dtype=blocks[which[0]].dtype, pin_memory=pinned)
    pos = torch.arange(width)
    cuts = [0, *(np.flatnonzero(np.diff(which)) + 1).tolist(), k]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        block = blocks[which[lo]]
        if block.shape[0]:  # an empty segment's row is all padding
            idx = (torch.from_numpy(starts[lo:hi])[:, None] + pos).clamp_(max=block.shape[0] - 1)
            torch.index_select(block, 0, idx.view(-1), out=out[lo:hi].view(-1))
    return out.masked_fill_(pos >= torch.from_numpy(lens)[:, None], fill)


def _own_blocks(segments):
    """(which, starts, lens) of a list of segments, each its own block."""
    k = len(segments)
    return (np.arange(k), np.zeros(k, np.int64),
            np.array([s.shape[0] for s in segments], np.int64))


def _merge_bucket(blocks, which, starts, lens, *, use_pallas, descending, dtype, device,
                  wide_merge) -> torch.Tensor:
    """One bucket's segments merged on ``device`` and decoded there before
    one copy back; a single segment runs no merge and is decoded on the
    host."""
    if lens.size == 1:
        s = int(starts[0])
        return _decode(blocks[which[0]][s:s + int(lens[0])], descending, dtype)
    fill = kops.sentinel_for(blocks[which[0]].dtype)
    stacked = _gather_padded(blocks, which, starts, lens, fill, device.type == "cuda")
    merged = merge_lib.merge_padded_runs(stacked.to(device, non_blocking=True),
                                         use_pallas=use_pallas, wide_merge=wide_merge)
    return _decode(merged[:int(lens.sum())], descending, dtype).cpu()


def merge_segments(segments: list[torch.Tensor], *, use_pallas: bool = True,
                   descending: bool = False, dtype=None, device=None,
                   nan_keys: bool = False) -> torch.Tensor:
    """Merge k sorted (encoded) host segments into one sorted host tensor
    in ``dtype`` (the caller's; None keeps the segments'), on ``device``:
    pass 3's bucket merge.

    ``descending=True``: the segments are flip-encoded; the inverse flip
    runs on the device before the copy back (on the host for a single
    segment, which runs no merge)."""
    if not segments:
        return torch.empty(0)
    return _merge_bucket(segments, *_own_blocks(segments), use_pallas=use_pallas,
                         descending=descending, dtype=dtype, device=_device.resolve(device),
                         wide_merge=kops.rank_functions(nan_keys)[1])


def _segment_stable_single(ks: torch.Tensor, vs: torch.Tensor, device) -> torch.Tensor:
    """The device tie fix of a single-segment bucket: one run is still
    segment-interleaved within its equal-key runs (the chunk sort's
    investigator splits tied ranges), so the payload is reordered
    ascending within each run of equal keys here too. (``repro`` pads the
    segment to a power of two for program reuse; the pads form their own
    trailing tie segment, so the result is the same without them.)"""
    if ks.shape[0] <= 1:
        return vs
    return segment_stable_kv(ks.to(device), vs.to(device)).cpu()


def _merge_bucket_kv(blocks, value_blocks, which, starts, lens, *, use_pallas, descending,
                     segment_stable, dtypes, device):
    """Key/value twin of ``_merge_bucket``; the tie fix (``segment_stable``)
    runs on the device after the merge and before the copy back."""
    if lens.size == 1:
        s, n = int(starts[0]), int(lens[0])
        ks, vs = blocks[which[0]][s:s + n], value_blocks[which[0]][s:s + n]
        if segment_stable:
            vs = _segment_stable_single(ks, vs, device)
        return _decode(ks, descending, dtypes[0]), keyenc.from_lane(vs, dtypes[1] or vs.dtype)
    pinned = device.type == "cuda"
    ks, vs = (_gather_padded(b, which, starts, lens, kops.sentinel_for(b[which[0]].dtype),
                             pinned).to(device, non_blocking=True)
              for b in (blocks, value_blocks))
    mk, mv = merge_lib.merge_padded_runs_kv(ks, vs, use_pallas=use_pallas)
    total = int(lens.sum())
    mk, mv = mk[:total], mv[:total]
    if segment_stable:
        # ties are flip-invariant: the tie fix runs on the encoded keys
        mv = segment_stable_kv(mk, mv)
    return (_decode(mk, descending, dtypes[0]).cpu(),
            keyenc.from_lane(mv, dtypes[1] or mv.dtype).cpu())


def merge_segments_kv(key_segments, value_segments, *, use_pallas: bool = True,
                      descending: bool = False, segment_stable: bool = False,
                      dtypes=(None, None), device=None):
    """Key/value twin of ``merge_segments``. ``segment_stable=True`` runs
    the argsort tie fix (``local_sort.segment_stable_kv``) on the bucket
    on the device, after the merge and before the copy back; only
    equal-key runs that cross bucket boundaries remain for the caller's
    host stitch (``planner._stitch_bucket_ties``)."""
    if not key_segments:
        return torch.empty(0), torch.empty(0)
    return _merge_bucket_kv(key_segments, value_segments, *_own_blocks(key_segments),
                            use_pallas=use_pallas, descending=descending,
                            segment_stable=segment_stable, dtypes=dtypes,
                            device=_device.resolve(device))


def _chunk_slices(n: int, out_chunk: int | None):
    """(lo, hi) spans cutting [0, n) into <= out_chunk pieces."""
    step = out_chunk if out_chunk else n  # None/0 -> one whole-bucket chunk
    for lo in range(0, n, max(step, 1)):
        yield lo, min(lo + step, n)


def external_merge(part: Partition, *, use_pallas: bool = True, out_chunk: int | None = None,
                   descending: bool = False, trace=None, device=None) -> Iterator[torch.Tensor]:
    """Yield the sorted dataset as a stream of sorted CPU tensors.

    With ``descending=True`` (flip-encoded partition) encoded-ascending
    bucket order is decoded-descending order, so the stream yields the
    descending output chunk by chunk. ``trace`` records one ``merge`` span
    per bucket (segment sizes as counts; the span includes the bucket's
    gather from the runs, its device decode and copy back)."""
    dev = _device.resolve(device)
    wide_merge = kops.rank_functions(part.nan_keys)[1]
    for b in range(part.n_buckets):
        with _span(trace, "merge", bucket=b) as sp:
            which, starts, lens = part.bucket(b)
            sp.counts(lens)
            if not lens.size:
                continue
            merged = _merge_bucket(part.blocks, which, starts, lens, use_pallas=use_pallas,
                                   descending=descending, dtype=part.dtype, device=dev,
                                   wide_merge=wide_merge)
        for lo, hi in _chunk_slices(merged.shape[0], out_chunk):
            yield merged[lo:hi]


def external_merge_kv(part: Partition, *, use_pallas: bool = True,
                      out_chunk: int | None = None, descending: bool = False, trace=None,
                      segment_stable: bool = False, device=None):
    """Key/value twin of ``external_merge``: yields (keys, values) CPU
    tensor pairs."""
    assert part.value_blocks is not None, "partition carries no values"
    dev = _device.resolve(device)
    for b in range(part.n_buckets):
        with _span(trace, "merge", bucket=b) as sp:
            which, starts, lens = part.bucket(b)
            sp.counts(lens)
            if not lens.size:
                continue
            mk, mv = _merge_bucket_kv(part.blocks, part.value_blocks, which, starts, lens,
                                      use_pallas=use_pallas, descending=descending,
                                      segment_stable=segment_stable,
                                      dtypes=(part.dtype, part.value_dtype), device=dev)
        for lo, hi in _chunk_slices(mk.shape[0], out_chunk):
            yield mk[lo:hi], mv[lo:hi]
