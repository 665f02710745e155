"""Out-of-core streaming sort built on the in-core sample sort.

Counterpart of ``repro.stream``. Three passes, each bounded by one
device-sized chunk, map the paper's six steps (§IV) from processors to
runs:

  pass 1  ``runs.py``            run generation: chunk the host dataset,
                                 sort each chunk with the sample sort,
                                 with the host-to-device copies of one
                                 chunk overlapping the sort of the last
                                 (pinned buffers, a copy stream, events);
  pass 2  ``partition.py``       global range partitioning: regular
                                 sampling of every run, replicated
                                 splitter selection, investigator
                                 boundaries per run (Table II balance
                                 across passes);
  pass 3  ``external_merge.py``  each range bucket's per-run segments
                                 merged by the balanced pairwise merge
                                 tree, streamed out as sorted chunks.

``driver.py`` glues the passes into ``sort_external`` / ``sort_stream``.
Outputs are CPU tensors. ``service.py`` is the serving front end's flush
core (``SortService``, ``FlushEngine``, ``ProgramCache``): shape-bucketed
requests sorted as one batched sort each.
"""
from repro_torch.stream.runs import Run, StreamConfig, generate_runs, iter_chunks
from repro_torch.stream.partition import Partition, partition_runs, select_stream_splitters
from repro_torch.stream.external_merge import (
    external_merge,
    external_merge_kv,
    merge_segments,
    merge_segments_kv,
)
from repro_torch.stream.driver import sort_external, sort_external_kv, sort_stream
from repro_torch.stream.service import FlushEngine, SortRequest, SortService, SortServiceError

__all__ = [
    "Run", "StreamConfig", "generate_runs", "iter_chunks",
    "Partition", "partition_runs", "select_stream_splitters",
    "external_merge", "external_merge_kv", "merge_segments", "merge_segments_kv",
    "sort_external", "sort_external_kv", "sort_stream",
    "FlushEngine", "SortRequest", "SortService", "SortServiceError",
]
