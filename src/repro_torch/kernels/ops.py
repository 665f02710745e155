"""Dispatch around the sorting kernels.

Counterpart of ``repro/kernels/ops.py``:
  * pad rows to a power of two with order-preserving sentinels,
  * choose the path: the bitonic kernels (``use_pallas=True``, the name
    kept from ``repro.SortConfig``) or a stable ``torch.sort``, which is
    also the path for rows longer than ``MAX_PALLAS_ROW``,
  * merge rows whose output exceeds ``MAX_PALLAS_ROW`` by rank
    arithmetic (``_scatter_merge``): a batched ``torch.searchsorted`` plus
    a scatter, ties keeping ``a`` first; for keys holding a NaN,
    ``jnp.searchsorted``'s probes (``jax_searchsorted``) and one rule for
    colliding ranks (``_last_writers``), as ``repro`` (``rank_functions``
    picks the pair once per sort),
  * ``tile_sort``: the paper's local phase (sort fixed-size tiles, then a
    balanced pairwise merge tree, Fig. 2), over a batch of rows at once
    where ``repro`` used ``vmap``: one kernel launch sorts the tiles of
    every row, and one launch runs each merge round for every row.

Unsigned 16-, 32- and 64-bit keys never reach this module: PyTorch has
no comparisons, ``where`` or ``searchsorted`` on those dtypes, so
``core.keyenc.to_lane`` maps them onto signed lanes of the same width.
The rank merge takes int64 and float64 rows as it takes 32-bit ones.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import bitonic

# Above this row length repro leaves the Pallas kernels (VMEM budget); the
# port keeps the same threshold so both take the same paths.
MAX_PALLAS_ROW = 8192
# Tile width used by tile_sort for the paper's local phase.
DEFAULT_TILE = 1024


def sentinel_for(dtype: torch.dtype):
    """Largest representable value: padding that sorts to the end."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pad_rows(x: torch.Tensor, n_to: int, fill) -> torch.Tensor:
    pad = n_to - x.shape[-1]
    if pad == 0:
        return x
    tail = torch.full((*x.shape[:-1], pad), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=-1)


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def sort_rows(keys: torch.Tensor, *, use_pallas: bool = True) -> torch.Tensor:
    """Sort each row of (R, N) ascending; any row length."""
    n = keys.shape[-1]
    np2 = _next_pow2(n)
    if not use_pallas or np2 > MAX_PALLAS_ROW:
        return torch.sort(keys, dim=-1, stable=True).values
    work = _work_dtype(keys.dtype)
    padded = _pad_rows(keys.to(work), np2, sentinel_for(work))
    out = bitonic.bitonic_sort_rows(padded)
    return out[:, :n].to(keys.dtype)


def sort_rows_kv(keys, values, *, stable: bool = True, use_pallas: bool = True):
    """Key/value row sort (values carried through the same permutation)."""
    n = keys.shape[-1]
    np2 = _next_pow2(n)
    if not use_pallas or np2 > MAX_PALLAS_ROW:
        order = torch.sort(keys, dim=-1, stable=stable).indices
        return torch.gather(keys, -1, order), torch.gather(values, -1, order)
    kdtype = _work_dtype(keys.dtype)
    pk = _pad_rows(keys.to(kdtype), np2, sentinel_for(kdtype))
    pv = _pad_rows(values, np2, sentinel_for(values.dtype))
    ok, ov = bitonic.bitonic_sort_rows_kv(pk, pv, stable=stable)
    return ok[:, :n].to(keys.dtype), ov[:, :n]


def merge_rows(a: torch.Tensor, b: torch.Tensor, *, use_pallas: bool = True,
               wide_merge=None) -> torch.Tensor:
    """Merge two row-wise sorted (R, N) tensors into sorted (R, 2N).
    ``wide_merge``: the rank merge for rows past the kernels
    (``_scatter_merge`` unless ``rank_functions`` chose another)."""
    n = a.shape[-1]
    np2 = _next_pow2(n)
    if not use_pallas or 2 * np2 > MAX_PALLAS_ROW:
        return (wide_merge or _scatter_merge)(a, b)
    fill = sentinel_for(a.dtype)
    out = bitonic.bitonic_merge_rows(_pad_rows(a, np2, fill), _pad_rows(b, np2, fill))
    return out[:, : 2 * n]


def merge_rows_kv(ak, av, bk, bv, *, stable: bool = True, use_pallas: bool = True):
    n = ak.shape[-1]
    np2 = _next_pow2(n)
    if not use_pallas or 2 * np2 > MAX_PALLAS_ROW:
        return _scatter_merge_kv(ak, av, bk, bv)
    kfill = sentinel_for(ak.dtype)
    vfill = sentinel_for(av.dtype)
    ok, ov = bitonic.bitonic_merge_rows_kv(
        _pad_rows(ak, np2, kfill), _pad_rows(av, np2, vfill),
        _pad_rows(bk, np2, kfill), _pad_rows(bv, np2, vfill), stable=stable,
    )
    return ok[:, : 2 * n], ov[:, : 2 * n]


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Keys that compare as ``repro``'s searches compare ``x``: integers as
    they are; floats in jax's sort order (``lax._sort_lt_comparator`` after
    ``_canonicalize_float_for_sort``), where -0.0 equals +0.0, every NaN
    equals every other and lies above +inf. The float becomes the bits of
    its float32 value (int32; a float64 keeps its own bits, in int64),
    sign-folded so that signed comparison is the float order, with -0.0
    mapped onto +0.0 and each NaN onto the positive quiet NaN."""
    if not x.dtype.is_floating_point:
        return x
    f = x if x.dtype == torch.float64 else x.to(torch.float32)
    f = torch.where(f == 0, torch.zeros_like(f), f)
    f = torch.where(f != f, torch.full_like(f, float("nan")), f)
    lane, top = (torch.int64, 63) if f.dtype == torch.float64 else (torch.int32, 31)
    b = f.view(lane)
    return b ^ ((b >> top) & ((1 << top) - 1))


def jax_searchsorted(sorted_rows: torch.Tensor, queries: torch.Tensor, side: str) -> torch.Tensor:
    """``jnp.searchsorted`` row by row, probe for probe: (R, n) rows and
    (R, m) queries -> (R, m) int64 insertion points.

    jax 0.9's default method (``_searchsorted_via_scan``) runs a fixed
    ceil(log2(n + 1)) levels from low = 0, high = n, with
    mid = (low + high) // 2, and goes left where ``query <= row[mid]``
    (side "left") or ``query < row[mid]`` (side "right"), comparing in
    its total order (``_total_order_key``); the answer is ``high``. On a
    sorted NaN-free row this is ``torch.searchsorted``. A NaN, and the
    unsorted row a NaN leaves behind (a NaN before the +inf padding, or
    the bitonic network's comparisons with it), makes the answer depend
    on the exact probes, so the sort takes this search when its float keys
    hold a NaN."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    rows = _total_order_key(sorted_rows)
    q = _total_order_key(queries)
    n = rows.shape[-1]
    low = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    high = torch.full(q.shape, n, dtype=torch.int64, device=q.device)
    if n == 0:
        return high
    for _ in range(math.ceil(math.log2(n + 1))):
        mid = (low + high) // 2
        probe = torch.gather(rows, -1, mid)
        go_left = q <= probe if side == "left" else q < probe
        low, high = torch.where(go_left, low, mid), torch.where(go_left, mid, high)
    return high


def _merge_ranks(a: torch.Tensor, b: torch.Tensor, search=torch.searchsorted):
    """Output positions of every element of sorted rows ``a`` and ``b``:
    ties keep ``a`` first."""
    a, b = a.contiguous(), b.contiguous()
    ra = torch.arange(a.shape[-1], device=a.device) + search(b, a, side="left")
    rb = torch.arange(b.shape[-1], device=a.device) + search(a, b, side="right")
    return ra, rb


def _last_writers(ra: torch.Tensor, rb: torch.Tensor, n_out: int) -> torch.Tensor:
    """Where ranks collide (NaN keys), the element a serial scatter of
    ``a`` then ``b`` would leave: ``b`` over ``a``, and within one operand
    the higher index, which is what ``repro``'s scatter keeps on the CPU.
    Returns, per output position, the index into ``cat([a, b])`` of that
    writer, or -1 where nothing was written. ``amax`` does not depend on
    the order of the writes, so CUDA and the CPU keep the same element."""
    rows, na = ra.shape
    ids = torch.arange(na + rb.shape[-1], device=ra.device).expand(rows, -1)
    win = torch.full((rows, n_out), -1, dtype=torch.int64, device=ra.device)
    return win.scatter_reduce_(1, torch.cat([ra, rb], dim=1), ids, "amax")


def _scatter_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge sorted rows by rank arithmetic. Stable: ties keep ``a`` first."""
    ra, rb = _merge_ranks(a, b)
    out = torch.zeros((a.shape[0], a.shape[-1] + b.shape[-1]), dtype=a.dtype, device=a.device)
    out.scatter_(1, ra, a)
    out.scatter_(1, rb, b)
    return out


def _scatter_merge_total_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_scatter_merge`` as ``repro`` runs it on keys holding a NaN: its
    probes (``jax_searchsorted``), and where ranks collide the writer its
    scatter keeps (``_last_writers``); positions nothing wrote stay 0."""
    ra, rb = _merge_ranks(a, b, jax_searchsorted)
    win = _last_writers(ra, rb, a.shape[-1] + b.shape[-1])
    out = torch.gather(torch.cat([a, b], dim=1), 1, win.clamp(min=0))
    return out.masked_fill_(win < 0, 0)


def rank_functions(nan_keys: bool):
    """The splitter search and the wide-row merge of a keys-only sort:
    ``torch.searchsorted`` and ``_scatter_merge``, or, when its float keys
    hold a NaN (``nan_keys``), ``repro``'s probes and collision rule. A
    NaN-free sort never pays for the second pair."""
    if nan_keys:
        return jax_searchsorted, _scatter_merge_total_order
    return torch.searchsorted, _scatter_merge


def _scatter_merge_kv(ak, av, bk, bv):
    ra, rb = _merge_ranks(ak, bk)
    shape = (ak.shape[0], ak.shape[-1] + bk.shape[-1])
    ok = torch.zeros(shape, dtype=ak.dtype, device=ak.device)
    ok.scatter_(1, ra, ak)
    ok.scatter_(1, rb, bk)
    ov = torch.zeros(shape, dtype=av.dtype, device=av.device)
    ov.scatter_(1, ra, av)
    ov.scatter_(1, rb, bv)
    return ok, ov


# ------------------------------------------------------- paper local phase


def _merge_tree(runs, batch: int, merge):
    """Balanced pairwise merge rounds over (batch * r, L) runs: each round
    merges the even and odd runs of every batch row (Fig. 2's pairing)."""
    r = runs[0].shape[0] // batch
    while r > 1:
        halves = [x.reshape(batch, r, -1) for x in runs]
        evens = [x[:, 0::2].reshape(batch * r // 2, -1) for x in halves]
        odds = [x[:, 1::2].reshape(batch * r // 2, -1) for x in halves]
        runs = merge(evens, odds)
        r //= 2
    return runs


def tile_sort(x: torch.Tensor, *, tile: int = DEFAULT_TILE, use_pallas: bool = True,
              wide_merge=None) -> torch.Tensor:
    """Sort every row of ``x`` (..., n) like the paper's local phase.

    1. cut each row into ``tile``-sized slices (the paper's per-thread
       slices);
    2. sort every tile with the bitonic kernel (one launch for all rows);
    3. balanced pairwise merge tree: log2(T) rounds, each merging
       neighbouring runs (``wide_merge``: as in ``merge_rows``).
    """
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    batch = rows.shape[0]
    np2 = _next_pow2(n)
    work_dtype = _work_dtype(x.dtype)
    work = _pad_rows(rows.to(work_dtype), np2, sentinel_for(work_dtype))
    t = min(tile, np2)
    runs = sort_rows(work.reshape(batch * (np2 // t), t), use_pallas=use_pallas)
    (runs,) = _merge_tree(
        [runs], batch,
        lambda a, b: [merge_rows(a[0], b[0], use_pallas=use_pallas, wide_merge=wide_merge)],
    )
    return runs.reshape(batch, np2)[:, :n].to(x.dtype).reshape(x.shape)


def tile_sort_kv(keys, values, *, tile: int = DEFAULT_TILE, stable: bool = True,
                 use_pallas: bool = True):
    """Key/value variant of ``tile_sort`` over rows of (..., n)."""
    n = keys.shape[-1]
    rk = keys.reshape(-1, n)
    batch = rk.shape[0]
    np2 = _next_pow2(n)
    kdtype = _work_dtype(keys.dtype)
    wk = _pad_rows(rk.to(kdtype), np2, sentinel_for(kdtype))
    wv = _pad_rows(values.reshape(-1, n), np2, sentinel_for(values.dtype))
    t = min(tile, np2)
    rk, rv = sort_rows_kv(
        wk.reshape(-1, t), wv.reshape(-1, t), stable=stable, use_pallas=use_pallas
    )
    rk, rv = _merge_tree(
        [rk, rv], batch,
        lambda a, b: merge_rows_kv(a[0], a[1], b[0], b[1], stable=stable,
                                   use_pallas=use_pallas),
    )
    ok = rk.reshape(batch, np2)[:, :n].to(keys.dtype).reshape(keys.shape)
    return ok, rv.reshape(batch, np2)[:, :n].reshape(values.shape)
