"""Top-k and binary-search views on sorted data (paper §III/IV: "retrieving
top values from their graph data or implementing binary search on the
sorted data").

Counterpart of ``repro/core/topk.py``. The ``*_sorted`` functions are the
one definition of the sort-then-slice views that ``SortOutput.topk`` /
``.searchsorted`` use; they run on the keys' device and return tensors
there. They answer as ``repro``'s numpy versions do: ``searchsorted`` in
numpy's order (-0.0 equal to +0.0, NaN above +inf), ``percentile_sorted``
by numpy's linear interpolation in float64, bit for bit. uint16, uint32
and uint64 keys and queries compare through their signed lanes
(``keyenc.to_lane``).

``topk_shard`` is the global top-k over a mesh axis (``repro`` runs it
inside ``shard_map``): every rank of the axis group calls it with its
shard; the local top-k, an all_gather of the candidates and their local
indices, and the same final selection on every rank. It selects as
``jax.lax.top_k`` does, by a stable sort: floats in their total order
(+0.0 above -0.0, a NaN above +inf or, with its sign bit, below -inf),
ties to the lower index, and ``largest=False`` as ``repro``'s top-k of
``-x`` (so the int minimum, whose negation wraps, counts as the largest).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import keyenc
from repro_torch.kernels import ops as kops


def _rev(x: torch.Tensor) -> torch.Tensor:
    """``x[::-1]`` for every admitted dtype (through the lane: PyTorch has
    no flip of unsigned tensors)."""
    return keyenc.from_lane(keyenc.to_lane(x).flip(0), x.dtype)


def local_topk(x: torch.Tensor, k: int, largest: bool = True):
    """Top-k of a flat local shard: (values, indices), ``torch.topk``."""
    v, i = torch.topk(keyenc.to_lane(x), k, largest=largest)
    return keyenc.from_lane(v, x.dtype), i


_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _top_order(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """Indices of flat ``x`` best first, as ``jax.lax.top_k`` ranks ``x``
    (``largest``) or ``-x``: the bits of each element as a signed integer
    that orders as jax compares, then a stable sort (ties keep the lower
    index)."""
    lane = _INT_OF_WIDTH[x.element_size()]
    sign = torch.iinfo(lane).min
    bits = x.view(lane) if x.dtype != lane else x
    if x.dtype.is_floating_point:
        if not largest:
            bits = bits ^ sign  # -x flips the sign bit
        key = torch.where(bits < 0, bits ^ torch.iinfo(lane).max, bits)
    else:
        key = bits if largest else -bits  # wraps, as jax's -x
        if x.dtype in keyenc._LANES or x.dtype == torch.uint8:
            key = key ^ sign  # unsigned order as signed
    return torch.sort(~key.to(torch.int64), stable=True).indices


def _top(x: torch.Tensor, k: int, largest: bool):
    if k > x.shape[0]:
        raise ValueError(f"k={k} is larger than the {x.shape[0]} candidates")
    idx = _top_order(x, largest)[:k]
    return keyenc.take(x, idx), idx.to(torch.int32)


def topk_shard(x_local: torch.Tensor, k: int, axis, largest: bool = True):
    """Global top-k over a mesh axis: (values, local indices), best first,
    the same on every rank. ``axis``: ``(mesh, axis)``, a mesh (axis
    "data") or a ``sharding.spec.AxisGroup``; every rank of the group calls
    it. O(p * k) gathered elements, no full sort."""
    from repro_torch.sharding import spec

    ag = spec.as_axis_group(axis)
    x = x_local.reshape(-1)
    v, i = _top(x, min(k, x.shape[0]), largest)
    allv, alli = ag.all_gather(v).reshape(-1), ag.all_gather(i).reshape(-1)
    fv, pos = _top(allv, k, largest)
    return fv, alli[pos.long()]


def _search_keys(keys: torch.Tensor, queries: torch.Tensor):
    """``keys`` and ``queries`` as tensors whose order is numpy's compare:
    unsigned keys by their lanes (queries cast to the keys' dtype), other
    pairs at their common dtype, floats by ``ops._total_order_key``
    (-0.0 == +0.0, every NaN equal and above +inf)."""
    if keys.dtype in keyenc._LANES:
        return keyenc.to_lane(keys), keyenc.to_lane(queries.to(keys.device).to(keys.dtype))
    common = torch.promote_types(keys.dtype, queries.dtype)
    if common.is_floating_point and common.itemsize < 8 and (
            keys.dtype.itemsize == 8 or queries.dtype.itemsize == 8):
        common = torch.float64  # numpy's promotion of a 64-bit int with a float
    k, q = keys.to(common), queries.to(keys.device).to(common)
    return kops._total_order_key(k), kops._total_order_key(q)


def _queries(queries) -> torch.Tensor:
    """Queries as a tensor of their own shape (a scalar stays 0-d)."""
    from repro_torch.core.planner import as_tensor

    if isinstance(queries, torch.Tensor):
        return queries
    return as_tensor(queries).reshape(np.shape(queries))


def searchsorted_sorted(keys: torch.Tensor, queries, *, side: str = "left",
                        descending: bool = False) -> torch.Tensor:
    """Global insertion ranks (``np.searchsorted``'s) of ``queries`` into the
    sorted flat ``keys``, aware of descending order: int64, the queries'
    shape, on the keys' device."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    q = _queries(queries)
    if descending:
        k, other = _rev(keys), {"left": "right", "right": "left"}[side]
        kk, qq = _search_keys(k, q)
        return keys.shape[0] - torch.searchsorted(kk, qq.reshape(-1), side=other).reshape(q.shape)
    kk, qq = _search_keys(keys, q)
    return torch.searchsorted(kk, qq.reshape(-1), side=side).reshape(q.shape)


def topk_sorted(keys: torch.Tensor, k: int, *, largest: bool = True,
                descending: bool = False) -> torch.Tensor:
    """Top-k of a sorted flat array, best first. ``descending`` names the
    array's own order, not the output's (``repro``'s slices, ``k = 0``
    included)."""
    k = min(int(k), keys.shape[0])
    if largest:
        return keys[:k] if descending else _rev(keys[-k:])
    return _rev(keys[-k:]) if descending else keys[:k]


def _float64(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float64, rounded once as numpy rounds it (a uint64 by its
    two 32-bit halves, each exact in float64)."""
    if x.dtype == torch.uint64:
        lane = keyenc.to_lane(x) ^ keyenc._LANES[torch.uint64][1]  # the bits, as int64
        hi = ((lane >> 32) & 0xFFFFFFFF).to(torch.float64)
        return hi * 4294967296.0 + (lane & 0xFFFFFFFF).to(torch.float64)
    if x.dtype in keyenc._LANES:
        return (keyenc.to_lane(x).to(torch.int64) - keyenc._LANES[x.dtype][1]).to(torch.float64)
    return x.to(torch.float64)


def percentile_sorted(keys: torch.Tensor, q, *, descending: bool = False) -> torch.Tensor:
    """Percentile(s) ``q`` (0-100) of the sorted flat ``keys``:
    ``np.percentile`` of the data with linear interpolation, bit for bit
    (numpy's virtual index, bounds and ``_lerp``, in float64); a float64
    tensor of ``q``'s shape on the keys' device."""
    x = _float64(_rev(keys) if descending else keys)
    qs = torch.as_tensor(q, dtype=torch.float64).to(x.device) / 100.0
    if not bool(((qs >= 0) & (qs <= 1)).all()):
        raise ValueError("Percentiles must be in the range [0, 100]")
    n = x.shape[0]
    virtual = (n - 1) * qs
    prev = torch.floor(virtual)
    nxt = prev + 1
    above, below = virtual >= n - 1, virtual < 0
    prev = torch.where(above, -1.0, torch.where(below, 0.0, prev))
    nxt = torch.where(above, -1.0, torch.where(below, 0.0, nxt))
    gamma = virtual - prev
    a, b = x[prev.long() % n], x[nxt.long() % n]
    diff = b - a
    out = torch.where(gamma >= 0.5, b - diff * (1 - gamma), a + diff * gamma)
    if bool(x.isnan().any()):  # numpy: a slice holding NaN gives NaN
        out = torch.full_like(out, float("nan"))
    return out


def searchsorted_in_result(values: torch.Tensor, counts: torch.Tensor, queries):
    """Binary search over a distributed-sort result (global view).

    values: (p, cap) sentinel-padded sorted shards; counts: (p,). Returns
    (proc, local_idx) per query: the shard owning the insertion point and
    the position within it (``jnp.searchsorted``'s probes and order)."""
    from repro_torch.core.planner import as_tensor

    p = values.shape[0]
    counts = as_tensor(counts).to(values.device).to(torch.int64)
    q = _queries(queries).to(values.device).to(values.dtype)
    v, q = keyenc.to_lane(values), keyenc.to_lane(q)
    per = kops.jax_searchsorted(v, q.reshape(1, -1).expand(p, -1).contiguous(), "left")
    ranks = torch.minimum(per, counts[:, None]).sum(0)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    proc = torch.searchsorted(ends, ranks, side="right").clamp(0, p - 1)
    return proc.reshape(q.shape), (ranks - starts[proc]).reshape(q.shape)
