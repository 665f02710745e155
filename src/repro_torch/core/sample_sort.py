"""PGX.D distributed sample sort over a mesh axis, on ``torch.distributed``.

Counterpart of ``repro/core/sample_sort.py``. ``repro`` runs the paper's
six steps as one ``shard_map`` body per device; the port runs them as
SPMD: every rank of the axis group calls with its own shard and gets its
own row of the result, with ``torch.distributed`` collectives through
``sharding.spec.AxisGroup`` (rank-major, in the mesh's coordinate order):

  master gather + broadcast  ->  all_gather of the samples + replicated
                                 selection on every rank
  async p2p send/recv        ->  one static-capacity all_to_all of the
                                 (p, cap) buckets and of the send counts
  the overflow flag          ->  all-reduced (MAX), so every rank sees the
                                 same flag and the ladder retries in step

The local math is the sim's (``core/sim.py``), on a one-row grid: the
tile sort and merge tree (``local_sort``), sampling, splitter selection,
the investigator's bounds, the bucket gather (``sim._gather_buckets``)
and the balanced merge of the p received runs. So row r of a mesh sort
equals row r of ``sim.sample_sort_sim`` on the stacked shards, bit for
bit, as ``repro``'s mesh equals its sim. On CUDA tensors every step
launches the port's bitonic kernels; the collectives move the tensors
where they live (gloo through the host, NCCL on the card).

The sort axis is one mesh axis ("data") or a tuple (("data", "model")):
the flattened product, first name major. There is no compiled-program
cache: the port runs eagerly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import merge as merge_lib
from repro_torch.core import splitters as spl
from repro_torch.core.local_sort import local_sort, local_sort_kv
from repro_torch.core.sim import _gather_buckets
from repro_torch.kernels import ops as kops
from repro_torch.obs.tracing import maybe_span as _span
from repro_torch.sharding import spec


class ShardSortResult(NamedTuple):
    """One rank's row of a mesh sort (``repro``'s per-device result).

    values:      (p2 * cap,) sorted, sentinel padded.
    count:       () int32 valid prefix length.
    overflowed:  bool, reduced over the axis group: the same on every rank.
    send_counts: (p,) int32 this rank's bucket sizes per destination.
    """

    values: torch.Tensor
    count: torch.Tensor
    overflowed: bool
    send_counts: torch.Tensor


class ShardSortKVResult(NamedTuple):
    keys: torch.Tensor
    values: torch.Tensor
    count: torch.Tensor
    overflowed: bool
    send_counts: torch.Tensor


def _split(ag: spec.AxisGroup, xs: torch.Tensor, config: spl.SortConfig, investigator: bool,
           key_bytes: int, nan_keys: bool):
    """Steps 2-4 on one sorted shard (1, n): samples, all_gather, the
    replicated splitters, the bounds and the reduced overflow flag."""
    p, n = ag.size, xs.shape[-1]
    search = kops.rank_functions(nan_keys)[0]
    samples = spl.regular_sample(xs[0], config.num_samples(p, n, key_bytes=key_bytes))
    splitters = spl.select_splitters(ag.all_gather(samples).reshape(-1), p, nan_keys)
    fn = spl.investigator_bounds if investigator else spl.naive_bounds
    bounds = fn(xs, splitters, search)  # (1, p + 1)
    send_counts = bounds[0, 1:] - bounds[0, :-1]
    local = bool((send_counts > config.capacity(p, n)).any())
    (flag,) = ag.all_max([local])
    return bounds, send_counts, bool(flag)


def _split_span(trace, ag, xs, config, investigator, key_bytes, nan_keys):
    with _span(trace, "splitter") as sp:
        bounds, send_counts, overflowed = sp.fence(
            _split(ag, xs, config, investigator, key_bytes, nan_keys))
        sp.set(overflowed=overflowed)
    return bounds, send_counts, overflowed


def _exchange(ag, grid: torch.Tensor, bounds: torch.Tensor, cap: int) -> torch.Tensor:
    """Step 5 for one array: the (p, cap) buckets, all-to-all; row i of the
    result is what coordinate i sent this rank."""
    return ag.all_to_all(_gather_buckets(grid, bounds, cap)[0])


def sample_sort_shard(x_local: torch.Tensor, axis, config: spl.SortConfig = spl.SortConfig(),
                      *, investigator: bool = True, nan_keys: bool = False,
                      trace=None) -> ShardSortResult:
    """The six steps on this rank's flat shard; every rank of the axis
    group calls it with a shard of the same length.

    ``axis``: an ``AxisGroup``, ``(mesh, axis)`` or a mesh (axis "data").
    ``nan_keys``: some rank's float keys hold a NaN (the planner's probe,
    reduced over the group); the searches and wide merges then follow
    ``repro``'s probes, as in ``sim.sample_sort_sim``. ``trace``: record
    the local_sort, splitter, exchange and merge spans, each fenced on
    this rank's device, with the per-rank counts gathered over the group
    (``repro``'s ``distributed_sort_phased``)."""
    ag = spec.as_axis_group(axis)
    p, (n,) = ag.size, x_local.shape
    cap = config.capacity(p, n)
    wide_merge = kops.rank_functions(nan_keys)[1]

    # (1) local sort
    with _span(trace, "local_sort") as sp:
        xs = sp.fence(local_sort(x_local[None], tile=config.tile, use_pallas=config.use_pallas,
                                 wide_merge=wide_merge))
        sp.counts([n] * p)

    # (2)+(3) samples -> all_gather -> replicated splitters; (4) bounds
    bounds, send_counts, overflowed = _split_span(trace, ag, xs, config, investigator,
                                                  x_local.element_size(), nan_keys)

    # (5) static-capacity exchange of the buckets and of their sizes
    # (a traced phase ends with a gather of the counts, so that it holds
    # the slowest rank's time, as repro's phase programs do)
    with _span(trace, "exchange") as sp:
        recv = _exchange(ag, xs, bounds, cap)
        count = sp.fence(ag.all_to_all(send_counts).sum(dtype=torch.int32))
        if trace is not None:
            sp.counts(ag.all_gather(count))

    # (6) balanced pairwise merge of the p received runs
    with _span(trace, "merge") as sp:
        merged = sp.fence(merge_lib.merge_padded_runs(recv[None], use_pallas=config.use_pallas,
                                                      wide_merge=wide_merge)[0])
        if trace is not None:
            sp.counts(ag.all_gather(count))
    return ShardSortResult(merged, count, overflowed, send_counts)


def sample_sort_shard_kv(keys_local: torch.Tensor, values_local: torch.Tensor, axis,
                         config: spl.SortConfig = spl.SortConfig(), *,
                         investigator: bool = True) -> ShardSortKVResult:
    """Key/value variant (provenance, payloads): the values ride every
    step, as in ``sim.sample_sort_sim_kv``."""
    ag = spec.as_axis_group(axis)
    p, (n,) = ag.size, keys_local.shape
    cap = config.capacity(p, n)
    ks, vs = local_sort_kv(keys_local[None], values_local[None], tile=config.tile,
                           use_pallas=config.use_pallas)
    bounds, send_counts, overflowed = _split(ag, ks, config, investigator,
                                             keys_local.element_size(), False)
    recv_k = _exchange(ag, ks, bounds, cap)
    recv_v = _exchange(ag, vs, bounds, cap)
    count = ag.all_to_all(send_counts).sum(dtype=torch.int32)
    mk, mv = merge_lib.merge_padded_runs_kv(recv_k[None], recv_v[None],
                                            use_pallas=config.use_pallas)
    return ShardSortKVResult(mk[0], mv[0], count, overflowed, send_counts)


# ------------------------------------------------------------ global entry


def distributed_sort(x_local: torch.Tensor, mesh, axis_name="data",
                     config: spl.SortConfig = spl.SortConfig(), *,
                     investigator: bool = True) -> ShardSortResult:
    """Sort the array whose shards the ranks of ``axis_name`` hold (equal
    lengths, block r on coordinate r); returns this rank's row of
    ``repro``'s (p, cap_total) global view."""
    return sample_sort_shard(x_local.reshape(-1), spec.axis_group(mesh, axis_name), config,
                             investigator=investigator)


def distributed_sort_kv(keys_local: torch.Tensor, values_local: torch.Tensor, mesh,
                        axis_name="data", config: spl.SortConfig = spl.SortConfig(), *,
                        investigator: bool = True) -> ShardSortKVResult:
    return sample_sort_shard_kv(keys_local.reshape(-1), values_local.reshape(-1),
                                spec.axis_group(mesh, axis_name), config,
                                investigator=investigator)


def distributed_sort_phased(x_local: torch.Tensor, mesh, axis_name="data",
                            config: spl.SortConfig = spl.SortConfig(), *,
                            investigator: bool = True, trace) -> ShardSortResult:
    """Traced keys-only mesh sort: the result of ``distributed_sort``, with
    the local_sort / splitter / exchange / merge spans on ``trace``, each
    fenced, with the per-rank counts. Each ladder step adds a set."""
    return sample_sort_shard(x_local.reshape(-1), spec.axis_group(mesh, axis_name), config,
                             investigator=investigator, trace=trace)
