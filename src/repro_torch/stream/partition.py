"""Global range partitioning across runs: pass 2 of the external sort
(paper steps 2-4 lifted from processors to runs).

Counterpart of ``repro/stream/partition.py``. Every run is sampled on the
host with the buffer-sized regular sampling rule, B-1 global splitters are
selected once on the device (``splitters.select_splitters``), and each
run's bucket boundaries come from one investigator search on the device
(``splitters.investigator_bounds``), read back in one copy per run.
Because the investigator pins every boundary to the run's ideal local
rank inside tied key ranges, a 90%-duplicate dataset still splits into
near-equal range buckets: the paper's Table II property across passes.

Bucket b holds every element in [splitter_{b-1}, splitter_b), already
sorted within each run's segment, so pass 3 only merges segments. The
partition keeps the host blocks the runs lie in (pass 1 writes them into
a few large buffers; a run made by hand is its own block), where each run
starts, and a (runs, B+1) matrix of boundaries; pass 3 gathers a bucket's
segments out of the blocks by index, and ``segments`` lists them as
``repro`` does. No second host copy of the dataset is made.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import splitters as spl
from repro_torch.kernels import ops as kops
from repro_torch.stream.runs import Run, StreamConfig


@dataclasses.dataclass
class Partition:
    """Pass-2 output: the B-1 global splitters (a CPU tensor of encoded
    keys); the host buffers of the runs (``blocks`` of keys,
    ``value_blocks`` of values or None), run r at ``offsets[r]`` of
    ``blocks[block_of[r]]``; and ``bounds[r, b]..bounds[r, b + 1]``, run
    r's slice for bucket b. ``dtype`` / ``value_dtype``: the caller's
    dtypes; ``nan_keys``: some run's chunk held a NaN key."""

    splitters: torch.Tensor
    blocks: list[torch.Tensor]
    value_blocks: list[torch.Tensor] | None
    block_of: np.ndarray
    offsets: np.ndarray
    bounds: np.ndarray
    bucket_sizes: np.ndarray
    dtype: torch.dtype | None = None
    value_dtype: torch.dtype | None = None
    nan_keys: bool = False

    @property
    def n_buckets(self) -> int:
        return self.bounds.shape[1] - 1 if self.offsets.size else 0

    def load_imbalance(self) -> float:
        """max/mean bucket size; 1.0 is perfect (paper Table II)."""
        if not self.bucket_sizes.size:
            return 1.0
        return float(self.bucket_sizes.max() / max(self.bucket_sizes.mean(), 1.0))

    def bucket(self, b: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(blocks, starts, lengths) of bucket b's non-empty segments, in
        run order: segment i is ``blocks[which[i]][starts[i]:][:lengths[i]]``."""
        lo, hi = self.bounds[:, b], self.bounds[:, b + 1]
        keep = np.nonzero(hi > lo)[0]
        return self.block_of[keep], self.offsets[keep] + lo[keep], (hi - lo)[keep]

    @property
    def segments(self) -> list[list[torch.Tensor]]:
        """``segments[b]``: the non-empty run slices of bucket b, in run
        order (encoded keys)."""
        return [[self.blocks[j][s:s + n] for j, s, n in zip(*self.bucket(b))]
                for b in range(self.n_buckets)]


def _homes(runs: list[Run]):
    """The distinct host blocks of the runs' keys and values, in order,
    and each run's block and offset in it."""
    blocks, value_blocks, block_of, offsets, seen = [], [], [], [], {}
    for r in runs:
        kb, vb, off = r.home if r.home is not None else (r.keys, r.values, 0)
        j = seen.setdefault(id(kb), len(blocks))
        if j == len(blocks):
            blocks.append(kb)
            value_blocks.append(vb)
        block_of.append(j)
        offsets.append(off)
    return (blocks, None if runs[0].values is None else value_blocks,
            np.array(block_of, np.int64), np.array(offsets, np.int64))


def _run_samples(run: Run, s: int) -> torch.Tensor:
    """Buffer-sized regular sampling of one sorted run, on the host (the
    centred-stride estimator of ``splitters.regular_sample``)."""
    n = len(run)
    s = max(1, min(s, n))
    idx = ((2 * np.arange(s, dtype=np.int64) + 1) * n) // (2 * s)
    return run.keys[torch.from_numpy(idx)]


def select_stream_splitters(runs: list[Run], n_buckets: int, sort_cfg: spl.SortConfig,
                            device=None) -> torch.Tensor:
    """Sample every run, pool the samples, select B-1 global splitters on
    ``device`` (returned there), in ``repro``'s NaN order when a run's
    chunk held a NaN.

    The per-run sample count follows the paper's buffer rule with the run
    count in place of p, so the sample volume stays bounded by
    ``buffer_bytes`` however many runs there are."""
    key_bytes = runs[0].keys.element_size()
    n_local = max(len(r) for r in runs)
    s = sort_cfg.num_samples(max(len(runs), 1), n_local, key_bytes=key_bytes)
    pooled = torch.cat([_run_samples(r, s) for r in runs])
    return spl.select_splitters(pooled.to(_device.resolve(device)), n_buckets,
                                any(r.nan_keys for r in runs))


def partition_runs(runs: list[Run], cfg: StreamConfig = StreamConfig(), *,
                   n_buckets: int | None = None, investigator: bool = True,
                   device=None) -> Partition:
    """Route every run's elements to global range buckets.

    One run at a time goes to the device for its boundary search, so
    device memory stays O(chunk) whatever the dataset's size."""
    if not runs:
        return Partition(torch.empty(0), [], None, np.zeros(0, np.int64),
                         np.zeros(0, np.int64), np.zeros((0, 1), np.int64),
                         np.empty(0, np.int64))
    dev = _device.resolve(device)
    lens = np.array([len(r) for r in runs], np.int64)
    total = int(lens.sum())
    if n_buckets is None:
        n_buckets = cfg.n_buckets or max(1, -(-total // cfg.chunk_elems))
    if n_buckets == 1:
        splitters = runs[0].keys[:0]
        bounds = np.stack([np.zeros_like(lens), lens], axis=1)
    else:
        splitters = select_stream_splitters(runs, n_buckets, cfg.sort, dev)
        bounds_fn = spl.investigator_bounds if investigator else spl.naive_bounds
        search = kops.rank_functions(any(r.nan_keys for r in runs))[0]
        bounds = np.empty((len(runs), n_buckets + 1), np.int64)
        for i, run in enumerate(runs):
            keys = run.keys.to(dev, non_blocking=True)
            bounds[i] = bounds_fn(keys[None], splitters, search)[0].cpu().numpy()  # one read
        splitters = splitters.cpu()
    return Partition(
        splitters, *_homes(runs), bounds, (bounds[:, 1:] - bounds[:, :-1]).sum(axis=0),
        runs[0].dtype, runs[0].value_dtype, any(r.nan_keys for r in runs),
    )
