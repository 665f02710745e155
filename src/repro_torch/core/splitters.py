"""Sampling, splitter selection and the paper's investigator (§IV, Fig. 3).

Counterpart of ``repro/core/splitters.py``. The functions take the sorted
shards (p, n) of a sort at once where ``repro`` mapped one shard with
``vmap``, and the shards of a batch of sorts (..., p, n) where ``repro``'s
serving flush mapped its whole sort with ``vmap``: every sort of the batch
has its own samples, splitters and bounds. The arithmetic is the same,
bounds are int32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Tuning knobs of the PGX.D sort, with the paper's defaults.

    buffer_bytes: the read-buffer size that bounds the total sample
      volume arriving at splitter selection (paper: 64 KB).
    capacity_factor: slack over the balanced shard size for the static
      exchange buckets; overflow is detected and reported, never silent.
    tile: tile width of the local bitonic sort phase.
    use_pallas: False sorts and merges with ``torch.sort`` and the rank
      merge instead of the bitonic kernels (the name is ``repro``'s).
    samples_per_shard: explicit override of the buffer rule (ablations).
    """

    buffer_bytes: int = 65536
    capacity_factor: float = 1.25
    tile: int = 1024
    use_pallas: bool = True
    samples_per_shard: int | None = None

    def num_samples(self, p: int, n_local: int, key_bytes: int = 4) -> int:
        """Paper rule: 64KB / p per processor, clamped to the shard size."""
        if self.samples_per_shard is not None:
            s = self.samples_per_shard
        else:
            s = max(1, self.buffer_bytes // (p * key_bytes))
        return max(1, min(s, n_local))

    def capacity(self, p: int, n_local: int) -> int:
        """Static per-destination bucket size: ideal * capacity_factor
        plus an additive floor of 32 (splitter noise is O(sqrt) in the
        sample count, so small shards need relatively more slack)."""
        ideal = (n_local + p - 1) // p
        cap = int(ideal * self.capacity_factor) + 32
        return min(cap, n_local)


def regular_sample(xs_sorted: torch.Tensor, s: int) -> torch.Tensor:
    """Regularly spaced samples of each sorted shard (p, n) -> (p, s).

    The index arithmetic is int64: ``repro`` computes it in int32, which
    wraps once (2s - 1) * n reaches 2^31 (n = 2^24 with s = 2048), so the
    two agree exactly below that size."""
    n = xs_sorted.shape[-1]
    idx = ((2 * torch.arange(s, device=xs_sorted.device) + 1) * n) // (2 * s)
    return xs_sorted[..., idx]


def select_splitters(all_samples: torch.Tensor, p: int, nan_keys: bool = False) -> torch.Tensor:
    """Replicated splitter selection (paper step 3): p-1 splitters at the
    regular ranks of the sorted (p*s,) sample set; a batch (..., p*s) of
    sample sets gives (..., p-1), one sort along the last axis.

    ``nan_keys`` (the sort's NaN decision, ``ops.rank_functions``): the
    samples sort by ``ops._total_order_key``, in ``repro``'s order on
    either device (every NaN after +inf whatever its sign bit), since the
    card's stable sort of a long float vector orders a NaN with its sign
    bit set first, which the CPU's puts last; a descending stream's flip
    makes such NaN. Without NaN the two orders are the same."""
    if nan_keys:
        order = torch.sort(kops._total_order_key(all_samples), dim=-1, stable=True).indices
        srt = torch.gather(all_samples, -1, order)
    else:
        srt = torch.sort(all_samples, dim=-1, stable=True).values
    m = srt.shape[-1]
    idx = (torch.arange(1, p, dtype=torch.int32, device=srt.device) * m) // p
    return srt[..., idx]


def _search(xs_sorted: torch.Tensor, splitters: torch.Tensor, side: str,
            search) -> torch.Tensor:
    """Every shard of (..., p, n) searched for its own sort's (..., p-1)
    splitters, as one (rows, p-1) search over all rows."""
    n = xs_sorted.shape[-1]
    rows = xs_sorted.numel() // n
    queries = splitters.unsqueeze(-2).expand(*xs_sorted.shape[:-1], -1)
    out = search(xs_sorted.reshape(rows, n).contiguous(),
                 queries.reshape(rows, queries.shape[-1]).contiguous(), side=side)
    return out.to(torch.int32).reshape(queries.shape)


def _with_ends(bound: torch.Tensor, n: int) -> torch.Tensor:
    edge = (*bound.shape[:-1], 1)
    zero = torch.zeros(edge, dtype=torch.int32, device=bound.device)
    full = torch.full(edge, n, dtype=torch.int32, device=bound.device)
    return torch.cat([zero, bound, full], dim=-1)


def investigator_bounds(xs_sorted: torch.Tensor, splitters: torch.Tensor,
                        search=torch.searchsorted) -> torch.Tensor:
    """Destination bounds with the paper's investigator (step 4, Fig. 3).

    For each splitter j the tied range [L_j, R_j] is found by a left and
    a right binary search, and bound j is the destination's ideal local
    rank j*n/p clipped into it: clip(j*n/p, L_j, R_j). This is a plain
    binary search on distinct data and the paper's equal division of a
    tied run that spans several splitters. Exact int32 arithmetic.

    xs_sorted: (..., p, n) sorted shards, splitters (..., p-1).
    ``search``: ``torch.searchsorted``, or another with its signature
    (``ops.rank_functions``). Returns (..., p, p+1) int32 bounds:
    bounds[i, j]..bounds[i, j+1] is the slice of shard i bound for j.
    """
    n = xs_sorted.shape[-1]
    p = splitters.shape[-1] + 1
    left = _search(xs_sorted, splitters, "left", search)
    right = _search(xs_sorted, splitters, "right", search)
    j = torch.arange(1, p, dtype=torch.int32, device=xs_sorted.device)
    ideal = (n // p) * j + ((n % p) * j) // p  # j*n/p without int32 overflow
    bound = torch.minimum(torch.maximum(ideal, left), right)
    return _with_ends(bound, n)


def naive_bounds(xs_sorted: torch.Tensor, splitters: torch.Tensor,
                 search=torch.searchsorted) -> torch.Tensor:
    """Plain sample-sort bounds (no investigator): the paper's Fig. 3b
    failure mode, kept as the ablation baseline."""
    return _with_ends(_search(xs_sorted, splitters, "left", search), xs_sorted.shape[-1])
