"""Key encodings and the fused device decode.

Counterpart of the single-key part of ``repro/core/keyenc.py``:

  * descending -> ``flip``, an order-reversing bijection per dtype (``~x``
    for integers, ``-x`` for floats); an ascending sort of flipped keys is
    a descending sort.
  * argsort    -> the payload is the flat global index (provenance); the
    kv sort is exactly stable for unique increasing payloads.
  * lanes      -> ``to_lane`` / ``from_lane``: uint16 and uint32 keys and
    values travel as int16 and int32 with the top bit flipped, a monotone
    bijection that maps the dtype's maximum onto the lane's maximum (so the
    padding sentinel stays the sentinel) and commutes with ``flip``.
    PyTorch has no comparisons, ``where`` or ``searchsorted`` on those
    unsigned dtypes. Every other admitted dtype is its own lane.

``decode_grid`` runs on the sort's device: the compaction of the padded
(p, W) result grid, the argsort tie fix and the inverse flip. Multi-key
packing is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.local_sort import segment_stable_kv

_LANES = {torch.uint16: (torch.int16, -(1 << 15)), torch.uint32: (torch.int32, -(1 << 31))}

PROVENANCE_INT32_CAP = 1 << 31
"""Largest element count an int32 provenance payload can index."""


class X64NotPortedError(TypeError, NotImplementedError):
    """A 64-bit dtype or index: ``repro`` refuses it at the door with a
    TypeError unless its x64 mode is on, and that mode is not ported."""


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def to_lane(x: torch.Tensor) -> torch.Tensor:
    if x.dtype in _LANES:
        lane, top = _LANES[x.dtype]
        return x.view(lane) ^ top
    return x


def from_lane(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype in _LANES:
        _, top = _LANES[dtype]
        return (x ^ top).view(dtype)
    return x


def flip(x: torch.Tensor) -> torch.Tensor:
    """Order-reversing bijection; its own inverse."""
    return -x if x.dtype.is_floating_point else ~x


def encode(keys: torch.Tensor, descending: bool) -> torch.Tensor:
    return flip(keys) if descending else keys


def provenance_dtype(n: int) -> torch.dtype:
    """The index dtype of an n-element provenance payload: int32 up to
    2^31 elements; past that it would need int64 (x64 mode)."""
    if n <= PROVENANCE_INT32_CAP:
        return torch.int32
    raise X64NotPortedError(
        f"provenance payload for n={n} elements overflows int32 (more than "
        f"2^31 global positions) and needs int64, which is x64 mode: not "
        f"ported to repro_torch yet (ROADMAP.md §1, item 2)"
    )


def check_payload_keys(keys: torch.Tensor, descending: bool) -> None:
    """Reject payload sorts whose keys collide with the padding sentinel.

    Ascending payload sorts cannot contain the key dtype's maximum (the
    padding sentinel); descending ones cannot contain its minimum (the
    flip maps it onto the sentinel); NaN keys order past the sentinel.
    Either way the exchange's pads would leak into the payload, so the
    sort raises the ValueError that ``repro`` raises, with the same text.
    Keys-only sorts are exempt.
    """
    dt_s = dtype_name(keys.dtype)
    if keys.dtype.is_floating_point and bool((keys != keys).any()):
        raise ValueError(
            "sort with a payload cannot contain NaN keys: NaN orders "
            "after the padding sentinel, so padding would leak into the "
            "output and the payload would come back corrupted. Drop or "
            "impute the NaNs first (np.nan_to_num / boolean masking)."
        )
    if dt_s == "bfloat16":
        bad = -np.inf if descending else np.inf
    elif keys.dtype.is_floating_point:
        bad = np.dtype(dt_s).type(-np.inf if descending else np.inf)
    else:
        info = np.iinfo(dt_s)
        bad = np.dtype(dt_s).type(info.min if descending else info.max)
    target = bad.item() if isinstance(bad, np.generic) else bad
    if bool((keys == target).any()):
        direction = "descending" if descending else "ascending"
        cause = (
            f"the order-flip encoding maps the {dt_s} minimum onto the "
            f"padding sentinel" if descending
            else f"it is the {dt_s} padding sentinel"
        )
        raise ValueError(
            f"{direction} sort with a payload cannot represent the key "
            f"{bad!r}: {cause}, so its payload would come back corrupted. "
            f"Shift or drop those keys first, or sort them keys-only "
            f"(no restriction without values/want='order')."
        )


def compact_rows(grid: torch.Tensor, counts: torch.Tensor, m: int) -> torch.Tensor:
    """Front-compact a sorted, sentinel-padded (p, W) grid into its first
    ``m`` global elements.

    ``repro`` writes row r of the grid at offset starts[r] = counts[:r].sum()
    into a zeroed buffer of m + W, row after row, with
    ``dynamic_update_slice``, which clamps a start past m down to m, so such
    a row lands in the scratch tail and never reaches [0, m). The port
    gathers the same result in one pass: position i holds what the last
    row whose clamped start is <= i wrote there, or 0 when that row's W
    elements end before i. (A scatter that clipped its indices into
    [0, m) instead would write those rows' pads over the real output.)"""
    p, w = grid.shape
    counts = counts.to(torch.int64).reshape(-1)
    starts = (torch.cumsum(counts, 0) - counts).clamp(0, m)
    pos = torch.arange(m, device=grid.device)
    row = torch.searchsorted(starts, pos, right=True) - 1
    off = pos - starts[row]
    out = grid[row, off.clamp(max=w - 1)]
    return out.masked_fill_(off >= w, 0)


def decode_grid(keys_grid, counts, values_grid=None, *, m: int,
                descending: bool = False, want_order: bool = False):
    """Device-side materialization of the first ``m`` sorted elements.

    ``m`` must not exceed the staged total (every real element and front
    pad), which is the sum of ``counts``.

      descending: keys were flip-encoded; apply the inverse flip.
      want_order: the payload is the provenance index; restore exact
                  stability with the segment-stable pass (the investigator
                  splits tied ranges across destinations).

    Returns ``(keys, values-or-None)`` of shape (m,).
    """
    ks = compact_rows(keys_grid, counts, m)
    vs = None
    if values_grid is not None:
        vs = compact_rows(values_grid, counts, m)
        if want_order:
            vs = segment_stable_kv(ks, vs)
    if descending:
        ks = flip(ks)
    return ks, vs
