"""Balanced pairwise merge tree over received runs (paper §IV step 6).

Counterpart of ``repro/core/merge.py``. After the exchange each
destination holds p sorted runs, sentinel padded to the bucket capacity;
every round merges equal-length neighbours. The port merges all
destinations of a (p_dst, p, C) grid in each round with one call.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops


def _pad_runs_pow2(runs: torch.Tensor, fill) -> torch.Tensor:
    p = runs.shape[-2]
    p2 = kops._next_pow2(p)
    if p2 == p:
        return runs
    pad = torch.full((*runs.shape[:-2], p2 - p, runs.shape[-1]), fill,
                     dtype=runs.dtype, device=runs.device)
    return torch.cat([runs, pad], dim=-2)


def merge_padded_runs(runs: torch.Tensor, *, use_pallas: bool = True,
                      wide_merge=None) -> torch.Tensor:
    """Merge (..., p, C) row-sorted runs into sorted (..., p2*C) rows
    (``wide_merge``: see ``ops.merge_rows``)."""
    fill = kops.sentinel_for(runs.dtype)
    lead = runs.shape[:-2]
    runs = _pad_runs_pow2(runs, fill)
    batch = math.prod(lead)
    flat = runs.reshape(-1, runs.shape[-1])
    (flat,) = kops._merge_tree(
        [flat], batch, lambda a, b: [kops.merge_rows(a[0], b[0], use_pallas=use_pallas,
                                                wide_merge=wide_merge)]
    )
    return flat.reshape(*lead, -1)


def merge_padded_runs_kv(keys, values, *, use_pallas: bool = True, stable: bool = True):
    """Key/value variant; the value payload rides the same permutation."""
    lead = keys.shape[:-2]
    keys = _pad_runs_pow2(keys, kops.sentinel_for(keys.dtype))
    values = _pad_runs_pow2(values, kops.sentinel_for(values.dtype))
    batch = math.prod(lead)
    fk, fv = kops._merge_tree(
        [keys.reshape(-1, keys.shape[-1]), values.reshape(-1, values.shape[-1])], batch,
        lambda a, b: kops.merge_rows_kv(a[0], a[1], b[0], b[1], stable=stable,
                                        use_pallas=use_pallas),
    )
    return fk.reshape(*lead, -1), fv.reshape(*lead, -1)
