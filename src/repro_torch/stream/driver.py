"""End-to-end external sort drivers: runs -> partition -> merge.

Counterpart of ``repro/stream/driver.py``. ``sort_external`` materializes
the sorted dataset on the host; ``sort_stream`` yields sorted chunks in
bounded memory. Both accept arrays (numpy arrays or tensors, which stay
where they are) or iterators of them, and return CPU tensors in the
caller's dtype.

``descending=True`` flips every chunk on the device at staging (pass 1)
and flips every output chunk back on the device (pass 3), so a descending
keys-only sort streams. With a tuner ambient, pass 1's cost per chunk
feeds the cost model (``chunk_sort`` on ``stream``), which sizes later
streams' chunks (``planner._pick_chunk_elems``).
"""
from __future__ import annotations

import time
from typing import Iterator

import torch

from repro_torch import tune as _tune
from repro_torch.core.planner import as_tensor
from repro_torch.obs.tracing import maybe_span as _span
from repro_torch.stream.external_merge import external_merge, external_merge_kv
from repro_torch.stream.partition import Partition, partition_runs
from repro_torch.stream.runs import StreamConfig, generate_runs


def _pipeline(data, cfg: StreamConfig, values=None, *, investigator: bool = True,
              stats: dict | None = None, descending: bool = False, trace=None,
              device=None) -> Partition | None:
    """Passes 1 and 2. None = empty dataset.

    ``stats`` (optional, mutated) receives ``chunk_retries`` (the
    per-chunk ladder steps of pass 1) and ``bucket_sizes`` (the output's
    bucket layout, which the planner's tie stitch needs). ``trace``
    records one ``local_sort`` span for pass 1 (per-run sizes as the
    processor counts, ``chunk_retries``) and one ``splitter`` span for
    pass 2 (per-bucket sizes); pass 3's ``merge`` spans are recorded per
    bucket by ``external_merge``."""
    with _span(trace, "local_sort") as sp:
        t0 = time.perf_counter()
        runs = generate_runs(data, cfg, values, investigator=investigator,
                             descending=descending, device=device)
        dt = time.perf_counter() - t0  # pass 1 ends with a wait on the device
        sp.counts([len(r) for r in runs])
        sp.set(chunk_retries=sum(r.retries for r in runs))
    tuner = _tune.current()
    if tuner is not None and runs:
        # the cost of one chunk (staging and the in-core sort, amortized
        # over the pass)
        tuner.observe("chunk_sort", "stream", runs[0].dtype, cfg.chunk_elems,
                      dt / len(runs) * 1e6)
    if stats is not None:
        stats["chunk_retries"] = [r.retries for r in runs]
    if not runs:
        return None
    with _span(trace, "splitter") as sp:
        part = partition_runs(runs, cfg, investigator=investigator, device=device)
        sp.counts(part.bucket_sizes)
    if stats is not None:
        stats["bucket_sizes"] = [int(b) for b in part.bucket_sizes]
    return part


def _empty_like(data) -> torch.Tensor:
    """An empty result of ``data``'s dtype: an array keeps its dtype, the
    argsort ``range`` is int32, and an exhausted iterator never exposed
    one, so it is float32, as in repro."""
    if isinstance(data, range):
        return torch.empty(0, dtype=torch.int32)
    if hasattr(data, "dtype"):
        return as_tensor(data.reshape(-1)[:0]).clone()
    return torch.empty(0, dtype=torch.float32)


def sort_stream(data, cfg: StreamConfig = StreamConfig(), *, investigator: bool = True,
                stats: dict | None = None, descending: bool = False, trace=None,
                device=None) -> Iterator[torch.Tensor]:
    """Out-of-core sort, streamed: yields sorted CPU tensors whose
    concatenation is the sorted dataset (descending when asked). Device
    memory is O(chunk)."""
    part = _pipeline(data, cfg, investigator=investigator, stats=stats,
                     descending=descending, trace=trace, device=device)
    if part is None:
        return
    yield from external_merge(part, use_pallas=cfg.sort.use_pallas,
                              out_chunk=cfg.out_chunk_elems or cfg.chunk_elems,
                              descending=descending, trace=trace, device=device)


def sort_external(data, cfg: StreamConfig = StreamConfig(), *, investigator: bool = True,
                  stats: dict | None = None, descending: bool = False, trace=None,
                  device=None) -> torch.Tensor:
    """Out-of-core sort, materialized on the host."""
    chunks = list(sort_stream(data, cfg, investigator=investigator, stats=stats,
                              descending=descending, trace=trace, device=device))
    return torch.cat(chunks) if chunks else _empty_like(data)


def sort_external_kv(keys, values, cfg: StreamConfig = StreamConfig(), *,
                     investigator: bool = True, stats: dict | None = None,
                     descending: bool = False, trace=None, segment_stable: bool = False,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Out-of-core key/value sort: the payload (``range(n)`` for the
    argsort index) rides every pass. ``segment_stable=True`` runs the
    equal-key tie fix on the device inside each bucket's merge; only ties
    crossing bucket boundaries remain for the caller (boundaries in
    ``stats["bucket_sizes"]``)."""
    part = _pipeline(keys, cfg, values, investigator=investigator, stats=stats,
                     descending=descending, trace=trace, device=device)
    if part is None:
        return _empty_like(keys), _empty_like(values)
    ks, vs = [], []
    for mk, mv in external_merge_kv(part, use_pallas=cfg.sort.use_pallas,
                                    out_chunk=cfg.out_chunk_elems or cfg.chunk_elems,
                                    descending=descending, trace=trace,
                                    segment_stable=segment_stable, device=device):
        ks.append(mk)
        vs.append(mv)
    return torch.cat(ks), torch.cat(vs)
