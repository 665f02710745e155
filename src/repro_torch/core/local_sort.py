"""Local sort phase (paper §IV step 1) and the device tie fix.

Counterpart of ``repro/core/local_sort.py``. The sorts take every shard
of a (p, n) grid at once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def local_sort(x: torch.Tensor, *, tile: int = 1024, use_pallas: bool = True,
               wide_merge=None) -> torch.Tensor:
    """Sort every row of ``x`` (..., n) ascending (``wide_merge``: see
    ``ops.merge_rows``)."""
    if not use_pallas:
        return torch.sort(x, dim=-1, stable=True).values
    return kops.tile_sort(x, tile=tile, use_pallas=True, wide_merge=wide_merge)


def local_sort_kv(keys, values, *, tile: int = 1024, use_pallas: bool = True,
                  stable: bool = True):
    """Sort (keys, values) rows by key; stable when values are unique
    increasing indices (the provenance payload)."""
    if not use_pallas:
        order = torch.sort(keys, dim=-1, stable=stable).indices
        return torch.gather(keys, -1, order), torch.gather(values, -1, order)
    return kops.tile_sort_kv(keys, values, tile=tile, stable=stable, use_pallas=True)


def segment_stable_kv(keys: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Reorder ``values`` ascending within each run of equal (already
    sorted) flat ``keys``.

    The investigator splits tied key ranges across destinations, so a
    provenance payload comes back interleaved within runs of equal keys.
    Sorting by (segment id, payload), as two stable sorts, restores
    exactly ``np.argsort(kind="stable")``."""
    if keys.shape[0] <= 1:
        return values
    step = (keys[1:] != keys[:-1]).to(torch.int32)
    seg = torch.cat([torch.zeros(1, dtype=torch.int32, device=keys.device), step]).cumsum(0)
    by_value = torch.sort(values, stable=True).indices
    by_segment = torch.sort(seg[by_value], stable=True).indices
    return values[by_value[by_segment]]
