"""Sort API: ``sort``, ``plan`` and ``explain``.

Counterpart of the unified front end of ``repro/core/api.py``::

    import repro_torch
    out = repro_torch.sort(keys)             # -> SortOutput, on "cuda"
    out.keys                                 # sorted keys, a device tensor
    repro_torch.sort(keys, device="cpu")     # the plain path, on the CPU
    out = repro_torch.sort((ids, times), order=("asc", "desc"))
    out.keys                                 # (ids, times), sorted by ids, then times

keys:   a flat tensor or numpy array, a (p, n_local) grid whose rows
        are the shards, a tuple of equal-length columns (a lexicographic
        multi-key sort; a 1-tuple is a single key), or an iterator (a
        list) of arrays, which streams.
values: optional payload that rides the sort.
order:  "asc" | "desc", or a tuple with one flag per key.
want:   "values" (sorted keys [+ payload]) | "order" (the stable sorting
        permutation).
where:  backend override: "sim", "stream", or a
        ``torch.distributed`` ``DeviceMesh`` / ``(mesh, axis)`` for the mesh
        backend (SPMD: see below).
limits: ``SortLimits``; config: ``SortConfig`` (the paper's defaults).
device: None means "cuda", which must exist; "cpu" on request only.

Stream (``where="stream"``, iterators, and inputs above
``SortLimits.stream_threshold`` = 2^22 elements): the keys stay where they
are and move to the device chunk by chunk (``chunk_elems``); the output
comes back as CPU tensors, lazily: ``.keys`` / ``.values`` / ``.order()``
run the passes, or ``out.chunks()`` yields the sorted chunks in bounded
memory (keys-only results; column tuples for a packed multi-key sort).
``SortLimits(trace=True)`` puts the phase spans on ``out.meta.trace``.

Multi-key strategy (``plan.multikey``, ``SortLimits.multikey``): when the
columns' measured (or declared, ``SortLimits.key_bits``) bit widths fit
31 bits, the tuple packs into ONE non-negative int32 key and sorts in one
pass ("packed"); otherwise, or for unpackable columns (float16,
bfloat16, a float column holding NaN), one stable argsort pass per key
("lsd"). ``repro_torch.explain`` names the decision and its reason. A
packed sort with a payload cannot hold a tuple that saturates a full
31-bit pack (it is the int32 padding sentinel) and raises ``repro``'s
ValueError; packed keys-only sorts have no restriction.

Decode (``SortLimits.decode``): "device" (default) builds the output on
the sort's device; "host" copies the result grid to the CPU and decodes
it with numpy, as ``repro``'s legacy path does. Both give the same bits;
the host decode returns CPU tensors.

Mesh (``where=mesh`` or ``(mesh, axis)``; ``axis`` a mesh dimension name
or a tuple of them, default "data"): every rank of the axis group calls
``sort(x_local, where=(mesh, axis))`` with its own shard (ranks that share
the group's coordinates pass the same shard) and gets back block r of the
global result (``out.block``), r its coordinate; ``counts``,
``send_counts``, ``overflowed`` and ``meta.retries`` are global. The
sort runs on the mesh's device type: ``device=None`` is this rank's
current CUDA device, ``device="cpu"`` a CPU (gloo) mesh::

    mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
    out = repro_torch.sort(x_local, where=(mesh, "data"))
    out.keys   # block out.block.index of the sorted concatenation of the shards

x64 mode (``core.x64``): int64, uint64 and float64 keys and values are
refused at the door with ``repro``'s TypeError unless the mode is on
(``enable_x64()``, ``REPRO_X64=1``, ``x64_mode()`` for a block, or
``SortLimits(x64=True)`` for one request; ``SortLimits(x64=False)`` keeps
a request at 32 bits). In the mode they sort through the 64-bit
instantiations of the bitonic kernels; tuples pack into one int64 sort up
to 63 bits; an argsort of more than 2^31 elements returns int64 indices.

Views (``SortOutput.topk``, ``.searchsorted``, ``.provenance``) and
``encode_provenance`` / ``decode_provenance`` / ``load_imbalance`` are
``repro``'s, on tensors.

``SortLibrary`` is ``repro``'s deprecated facade, kept for seed-era
callers: each method routes through ``sort`` with a pinned backend and
warns once per process; its ``sort_many`` runs same-shape grids as one
batched sort through the serve tier's ``ProgramCache``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import keyenc, planner, sim, topk
from repro_torch.core import x64 as _x64
from repro_torch.core.planner import SortLimits, SortPlan
from repro_torch.core.result import SortOutput
from repro_torch.core.splitters import SortConfig


def sort(keys, values=None, *, order="asc", want="values", where=None,
         limits: SortLimits | None = None, config: SortConfig | None = None,
         investigator: bool = True, device=None) -> SortOutput:
    """Sort ``keys`` (see the module docstring)."""
    return planner.execute(
        keys, values, order=order, want=want, where=where, limits=limits,
        config=config, investigator=investigator, device=device,
    )


def plan(keys, values=None, *, order="asc", want="values", where=None,
         limits: SortLimits | None = None, config: SortConfig | None = None,
         investigator: bool = True, device=None) -> SortPlan:
    """The backend the planner will use for this request, and why."""
    return planner.make_plan(
        keys, values, order=order, want=want, where=where, limits=limits,
        config=config, investigator=investigator, device=device,
    )


def explain(keys, values=None, **kwargs) -> str:
    """Human-readable rendering of ``plan(...)``."""
    return plan(keys, values, **kwargs).explain()


# ---------------------------------------------------------- provenance


def encode_provenance(p: int, n_local: int, device=None) -> torch.Tensor:
    """(p, n_local) index payload: global position = proc * n_local + local
    index, unique and increasing, so a kv sort carrying it is exactly
    stable and each element's (processor, location) can be recovered. int32
    up to ``keyenc.PROVENANCE_INT32_CAP`` elements; past that int64, which
    needs x64 mode (``keyenc.provenance_dtype`` raises otherwise)."""
    dt = keyenc.provenance_dtype(p * n_local, x64=_x64.x64_enabled())
    return torch.arange(p * n_local, dtype=dt, device=_device.resolve(device)).reshape(p, n_local)


def decode_provenance(payload: torch.Tensor, n_local: int):
    """(processor, local index) of each provenance value."""
    return payload // n_local, payload % n_local


def load_imbalance(counts) -> torch.Tensor:
    """max/mean shard size; 1.0 is perfect balance (paper Table II). A
    float32 scalar (float64 for 64-bit counts), as ``repro``'s."""
    c = planner.as_tensor(counts)
    wide = torch.float64 if c.dtype.itemsize == 8 else torch.float32
    return c.max().to(wide) / torch.clamp(c.to(wide).mean(), min=1)


# ------------------------------------------------------ legacy facade


_DEPRECATION_SEEN: set[str] = set()


def _warn_deprecated(name: str, instead: str) -> None:
    if name in _DEPRECATION_SEEN:
        return
    _DEPRECATION_SEEN.add(name)
    warnings.warn(f"SortLibrary.{name} is deprecated; use {instead}",
                  DeprecationWarning, stacklevel=3)


def _reset_deprecation_registry() -> None:
    """Test hook: make every shim warn again."""
    _DEPRECATION_SEEN.clear()


@dataclasses.dataclass(frozen=True)
class SortLibrary:
    """Deprecated facade over ``sort`` (``repro``'s, kept so seed-era
    callers run unchanged). Every method pins a backend and returns the
    legacy result type (``SortOutput.raw`` for the sim); each warns once
    per process. ``device``: None means "cuda" (raises without a card)."""

    config: SortConfig = SortConfig()
    investigator: bool = True
    device: Any = None

    def __post_init__(self):
        _device.resolve(self.device)  # the port's device rule, at construction

    def _sort(self, x, values=None, **kw) -> SortOutput:
        return sort(x, values, config=self.config, investigator=self.investigator,
                    device=self.device, **kw)

    _NO_RETRY = SortLimits(max_doublings=0, raise_on_overflow=False)

    # ---- virtual-processor (single device) paths ----
    def sort(self, x) -> sim.SortResult:
        """x: (p, n_local): sort across virtual processors."""
        _warn_deprecated("sort", "repro.sort(x)")
        return self._sort(x, where="sim", limits=self._NO_RETRY).raw

    def sort_with_provenance(self, x) -> sim.SortKVResult:
        _warn_deprecated("sort_with_provenance", 'repro.sort(x, want="order")')
        return self._sort(x, want="order", where="sim", limits=self._NO_RETRY).raw

    def sort_kv(self, keys, values) -> sim.SortKVResult:
        _warn_deprecated("sort_kv", "repro.sort(keys, values)")
        return self._sort(keys, values, where="sim", limits=self._NO_RETRY).raw

    def sort_many(self, arrays: Sequence):
        """Sort several independent (p, n_local) datasets at once (paper
        §IV end): same-shape arrays run as ONE batched sort, through the
        program cache shared with the serve tier."""
        _warn_deprecated("sort_many", "repro.sort per array")
        return _sort_many_batched(arrays, self.config, self.investigator,
                                  _device.resolve(self.device))

    def sort_with_retry(self, x, max_doublings: int = 3):
        """On (detected, never silent) bucket overflow, retry with the
        capacity ladder."""
        _warn_deprecated("sort_with_retry", "repro.sort(x) (retries by default)")
        out = self._sort(x, where="sim", limits=SortLimits(max_doublings=max_doublings))
        return out.raw, out.meta.config

    def searchsorted(self, result: sim.SortResult, queries):
        _warn_deprecated("searchsorted", "SortOutput.searchsorted(queries)")
        return topk.searchsorted_in_result(result.values, result.counts, queries)

    # ---- out-of-core paths (repro_torch.stream) ----
    def sort_external(self, data, *, chunk_elems: int = 1 << 16, n_procs: int = 8):
        """Sort a host-side dataset larger than one device program."""
        _warn_deprecated("sort_external", 'repro.sort(data, where="stream").keys')
        return self._sort(data, where="stream", limits=SortLimits(
            chunk_elems=chunk_elems, n_procs=n_procs)).keys

    def sort_external_kv(self, keys, values, *, chunk_elems: int = 1 << 16,
                         n_procs: int = 8):
        """Out-of-core key/value sort; the payload rides every pass."""
        _warn_deprecated("sort_external_kv", 'repro.sort(keys, values, where="stream")')
        out = self._sort(keys, values, where="stream", limits=SortLimits(
            chunk_elems=chunk_elems, n_procs=n_procs))
        return out.keys, out.values

    def sort_stream(self, data, *, chunk_elems: int = 1 << 16, n_procs: int = 8):
        """Like ``sort_external`` but yields sorted chunks in bounded memory."""
        _warn_deprecated("sort_stream", 'repro.sort(data, where="stream").chunks()')
        return self._sort(data, where="stream", limits=SortLimits(
            chunk_elems=chunk_elems, n_procs=n_procs)).chunks()

    # ---- real-mesh paths (SPMD: each rank passes its shard) ----
    @staticmethod
    def _check_divisible(x, mesh, axis_name) -> None:
        """``repro``'s legacy contract: the facade never pads, so uneven
        inputs keep failing loudly (``sort`` pads and unpads, but ``.raw``
        counts would include the sentinels). Here: every rank's shard has
        the same length, or every rank raises the same ValueError."""
        from repro_torch.sharding import spec

        ag = spec.as_axis_group((mesh, axis_name))
        lengths = ag.all_gather(torch.tensor(planner.as_tensor(x).numel())).tolist()
        if len(set(lengths)) > 1:
            raise ValueError(
                f"input length {sum(lengths)} does not divide the {ag.size}-way sort axis "
                f"(shard lengths {lengths}); use repro_torch.sort(x_local, where=mesh) "
                f"for automatic padding")

    def distributed_sort(self, x, mesh, axis_name="data"):
        """This rank's row (``sample_sort.ShardSortResult``) of the mesh sort
        of the ranks' equal shards, with no ladder retry."""
        _warn_deprecated("distributed_sort", "repro.sort(x, where=mesh)")
        self._check_divisible(x, mesh, axis_name)
        return self._sort(x, where=(mesh, axis_name), limits=self._NO_RETRY).raw

    def distributed_sort_kv(self, keys, values, mesh, axis_name="data"):
        _warn_deprecated("distributed_sort_kv", "repro.sort(keys, values, where=mesh)")
        self._check_divisible(keys, mesh, axis_name)
        return self._sort(keys, values, where=(mesh, axis_name), limits=self._NO_RETRY).raw


# ------------------------------------------------- batched sort_many


_SORT_MANY_CACHE = None


def sort_many_cache():
    """The ``ProgramCache`` behind ``SortLibrary.sort_many``, as ``repro``
    has it: it counts the (batch, shape, dtype) keys ``sort_many`` has run
    and compiles nothing."""
    global _SORT_MANY_CACHE
    if _SORT_MANY_CACHE is None:
        from repro_torch.stream.service import ProgramCache

        _SORT_MANY_CACHE = ProgramCache()
    return _SORT_MANY_CACHE


def _sort_many_batched(arrays, config: SortConfig, investigator: bool, dev: torch.device):
    """Group same-(shape, dtype) grids, stack each group and sort it as one
    batched sort; one ``sim.SortResult`` per array, in its dtype."""
    cache = sort_many_cache()
    arrays = [planner.as_tensor(a) for a in arrays]
    groups: dict[tuple, list[int]] = {}
    for i, a in enumerate(arrays):
        groups.setdefault((tuple(a.shape), a.dtype), []).append(i)
    results: list = [None] * len(arrays)
    for (shape, dtype), idxs in groups.items():
        planner.check_key_dtype(dtype)
        stacked = torch.stack([keyenc.to_lane(arrays[i].to(dev)) for i in idxs])
        fn = cache.get(len(idxs), shape[0], shape[1], dtype, config, investigator)
        nan_keys = stacked.dtype.is_floating_point and bool(stacked.isnan().any())
        res = fn(stacked, nan_keys=nan_keys)
        for slot, i in enumerate(idxs):
            results[i] = sim.SortResult(keyenc.from_lane(res.values[slot], dtype),
                                        res.counts[slot], res.overflowed[slot],
                                        res.send_counts[slot])
    return results
