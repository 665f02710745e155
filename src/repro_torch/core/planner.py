"""Execution planner and backend registry (the sim, stream and mesh backends).

Counterpart of ``repro/core/planner.py``. Placement rules, in order:
  1. ``where`` names a backend; a ``DeviceMesh`` or ``(mesh, axis)`` means
     the mesh backend.
  2. Iterator inputs stream (size unknown, not host-resident).
  3. Inputs above ``limits.stream_threshold`` elements stream.
  4. Everything else runs on the virtual-processor simulator.

The mesh backend (``_exec_mesh``, ``core/sample_sort.py``) is SPMD: every
rank of the axis group calls ``sort(x_local, where=(mesh, axis))`` with
its own shard and gets back block r of the global result, r its
coordinate along the axis (``SortOutput.block``); counts, send counts,
the overflow flag and the ladder's retries are global and the same on
every rank (see ``_exec_mesh``). A tuple of keys over the mesh packs with
ranges reduced over the ranks, or runs LSD passes whose gathers through
the permutation are indexed exchanges between the ranks
(``_exec_mesh_lsd``, ``_mesh_take``). With an ambient
``repro_torch.tune`` tuner whose model predicts both the sim and the stream confidently, the model may
override rule 3 (``_consult_cost_model``), size the stream's chunks
(``_pick_chunk_elems``) and start the overflow ladder where the
overflowed result's own counts say (``_measured_hook``); without one,
every decision is the static rule's, unchanged.

``execute_request`` runs an already-planned request: ``sort`` plans and
dispatches in one call, and the sort server plans at admission
(``serve_profile``) and dispatches later.

64-bit keys and values (int64, uint64, float64) need x64 mode
(``core.x64``: ``enable_x64()``, ``REPRO_X64=1`` or
``SortLimits(x64=True)``), resolved once per request and threaded to the
door checks, the pack budget, the provenance dtype and the stream.

A streamed request's keys stay where the caller put them; only chunks
move to the sort's device, and the output comes back as CPU tensors.
``SortLimits(trace=True)`` (or an ambient ``obs.trace()``) records the
phase spans of ``repro``'s traces on ``SortOutput.meta.trace``.

A tuple of key columns is a lexicographic multi-key sort
(``_decide_multikey``): one packed sort when the columns' widths fit the
pack budget (``keyenc.plan_pack``: an int32 up to 31 bits; an int64 up to
63 in x64 mode), else LSD passes of stable argsorts.
``SortLimits(decode="host")`` decodes the result grid with numpy
(``_grid_materialize``).
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import tune as _tune
from repro_torch.core import keyenc, sim
from repro_torch.core import x64 as _x64
from repro_torch.core.overflow import (
    OverflowPolicy,
    ladder_totals,
    measured_capacity_need,
    run_with_capacity_retry,
)
from repro_torch.core.result import Block, SortMeta, SortOutput, record_tune
from repro_torch.core.splitters import SortConfig
from repro_torch.kernels import ops as kops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.obs.tracing import maybe_span as _span

# one counter for every sort the planner dispatches, by the backend it chose
_SORTS_TOTAL = obs_metrics.counter(
    "repro_sorts_total",
    "Sorts executed by the unified front end, by planner backend.",
    labels=("backend",),
)

ADMITTED_DTYPES = (
    torch.int8, torch.int16, torch.int32, torch.uint8, torch.uint16, torch.uint32,
    torch.float16, torch.bfloat16, torch.float32,
)
# admitted in x64 mode only
WIDE_DTYPES = (torch.int64, torch.uint64, torch.float64)
# the cast remedy named in the 64-bit rejection, per offending dtype
_NEAREST_NARROW = {"int64": "int32", "uint64": "uint32", "float64": "float32"}
def as_tensor(x) -> torch.Tensor:
    """A tensor view of ``x``: tensors pass through, numpy arrays and
    Python lists are wrapped on the CPU (numpy bfloat16 by its bits)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def check_key_dtype(dt: torch.dtype, what: str = "keys", *, x64: bool | None = None) -> None:
    """Refuse at the door what the sort cannot take: 64-bit dtypes unless
    x64 mode admits them (``x64``: the request's resolved mode; None reads
    the ambient switch), with ``repro``'s TypeError naming the remedy: the
    opt-in or a cast to the nearest 32-bit dtype."""
    if dt in ADMITTED_DTYPES:
        return
    name = keyenc.dtype_name(dt)
    if dt in WIDE_DTYPES:
        if _x64.x64_enabled() if x64 is None else x64:
            return
        narrow = _NEAREST_NARROW[name]
        raise TypeError(
            f"64-bit {what} ({name}) need x64 mode, which is off. Opt in with "
            f"repro_torch.enable_x64(), REPRO_X64=1, or SortLimits(x64=True) — "
            f"or cast to {narrow} first (note np defaults Python ints to int64)."
        )
    raise TypeError(f"{what} of dtype {name} cannot be sorted; admitted: "
                    f"{[keyenc.dtype_name(d) for d in ADMITTED_DTYPES + WIDE_DTYPES]}")


@dataclasses.dataclass(frozen=True)
class SortLimits:
    """Resource hints the planner dispatches on; ``repro``'s fields and
    defaults.

    n_procs: virtual processors of the sim grid for flat inputs.
    chunk_elems: device-program capacity of one stream chunk.
    stream_threshold: element count above which the planner picks the
      out-of-core backend; None disables size-based streaming (explicit
      ``where="stream"`` and iterator inputs still stream).
    max_doublings / growth / raise_on_overflow: the overflow policy (see
      ``overflow.OverflowPolicy``). The stream backend honours
      max_doublings and growth but always raises when a chunk's ladder is
      exhausted: a partially exchanged run cannot be returned.
    max_request_elems: the sort server's per-request size cap
      (``RequestTooLargeError`` at admission); None admits any size.
    decode: "device" (default) decodes the result grid on the sort's
      device (``keyenc.decode_grid``). "host" copies the grid to the CPU
      and decodes it with numpy (``repro``'s legacy path: unpad, flip,
      tie fix, unpack), for differential testing: its outputs equal the
      device decode's bit for bit and come back as CPU tensors.
    multikey: strategy of a tuple sort. "auto" packs the tuple into one
      sort when its widths fit the pack budget (31 bits, an int32; 63 in
      x64 mode, an int64 above 31), else runs LSD passes; "packed"
      requires packing (raises with the reason when the tuple cannot
      pack); "lsd" always runs the passes.
    key_bits: per-key declared bit widths for the packer, e.g.
      ``(4, None, 10)``: entry i promises key i's values lie in
      ``[0, 2**bits)`` (checked at pack time; ints only; None measures).
      Single-key sorts ignore it.
    trace: record the phase spans of this sort (plan, encode, stage,
      local_sort, splitter, exchange, merge, decode, d2h; the stream's
      passes as local_sort, splitter and one merge per bucket) on
      ``SortOutput.meta.trace``, an ``obs.tracing.Trace``. The sim then
      fences each phase, so a span holds its device time. Default False:
      the untraced path is unchanged. An ambient ``obs.trace()`` block
      traces regardless of this flag.
    x64: this request's x64 mode (``core.x64``). None follows the ambient
      switch (``enable_x64()`` / ``REPRO_X64=1``); True admits 64-bit keys
      and values for this request; False keeps it at 32 bits even when
      the ambient mode is on.
    """

    n_procs: int = 8
    chunk_elems: int = 1 << 16
    stream_threshold: int | None = 1 << 22
    max_doublings: int = 3
    growth: float = 2.0
    raise_on_overflow: bool = True
    max_request_elems: int | None = None
    decode: str = "device"
    multikey: str = "auto"
    key_bits: tuple | None = None
    trace: bool = False
    x64: bool | None = None

    def policy(self) -> OverflowPolicy:
        return OverflowPolicy(
            max_doublings=self.max_doublings,
            growth=self.growth,
            raise_on_overflow=self.raise_on_overflow,
        )


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """The planner's decision: backend, shape and device of the execution."""

    backend: str
    n_procs: int
    chunk_elems: int
    limits: SortLimits
    device: torch.device
    reasons: tuple = ()
    decode: str = "device"
    key_width: int = 32  # bits of the widest key column; for an iterator
    #                      the widest the mode admits (64 or 32)
    multikey: str | None = None  # "packed" | "lsd"; None for single-key
    packspec: keyenc.PackSpec | None = None  # when multikey == "packed"
    x64: bool = False  # the request's resolved x64 mode
    cost_source: str = "static"  # "model" when an ambient tuner's cost model
    #                              (confidently) made the placement
    cost_predicted: Any = None  # {backend: {"us", "confidence"}}: the model's
    #                             predictions, kept even below the bar
    mesh: Any = None  # the DeviceMesh of a mesh sort
    axis_name: Any = "data"  # its sort axis: a name or a tuple of names
    group: Any = None  # this rank's sharding.spec.AxisGroup along the axis

    def explain(self) -> str:
        lines = [f"repro_torch.sort plan: backend={self.backend!r}"]
        lines += [f"  - {r}" for r in self.reasons]
        if self.cost_predicted:
            lines.append(f"  cost: source={self.cost_source}")
            for b in sorted(self.cost_predicted):
                d = self.cost_predicted[b]
                chosen = ("  <- chosen" if self.cost_source == "model"
                          and b == self.backend else "")
                lines.append(f"    {b}: predicted {d['us']:.0f}us "
                             f"(confidence {d['confidence']:.2f}){chosen}")
        if self.multikey is not None:
            detail = f" ({self.packspec.describe()})" if self.packspec is not None else ""
            lines.append(f"  multikey={self.multikey}{detail}")
        lines.append(
            f"  n_procs={self.n_procs} chunk_elems={self.chunk_elems} "
            f"decode={self.decode} "
            f"key_width={self.key_width}{' (x64 mode)' if self.x64 else ''} "
            f"device={self.device} "
            f"overflow: up to {self.limits.max_doublings} capacity bumps "
            f"(x{self.limits.growth})"
        )
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    description: str
    execute: Callable  # (_Req, SortPlan) -> SortOutput


BACKENDS: dict[str, Backend] = {}


def register_backend(name: str, execute: Callable, description: str) -> None:
    BACKENDS[name] = Backend(name, description, execute)


# --------------------------------------------------------------- request


@dataclasses.dataclass
class _Req:
    """Normalized sort request (internal)."""

    keys: Any  # flat (n,) or (p, n_local) tensor; a list of flat columns
    #            for multi-key; an iterator of chunks for stream inputs
    values: torch.Tensor | None
    want: str  # "values" | "order"
    descending: tuple  # per-key flags
    config: SortConfig
    investigator: bool
    n: int | None  # None for iterator inputs
    n_local: int | None  # set for (p, n_local) global-view inputs
    dtype: torch.dtype | None  # None for iterator inputs
    multikey: bool = False
    is_iterator: bool = False
    packspec: keyenc.PackSpec | None = None  # set on the packed sub-request:
    #                                          the decode unpacks the columns
    pack_ranks: dict | None = None  # rank tensors measured at plan time,
    #                                 reused by keyenc.pack_keys
    trace: Any = None  # obs.tracing.Trace of a traced sort (sub-requests
    #                    inherit it)
    mesh_lengths: np.ndarray | None = None  # a mesh tuple sort's shard length
    #                                         per coordinate (the preflight's)
    exchanges: dict = dataclasses.field(default_factory=dict)  # its indexed
    #                                         exchanges so far, by kind

    @property
    def needs_payload(self) -> bool:
        return self.want == "order" or self.values is not None


def _normalize(keys, values, *, order, want, config, investigator, x64: bool) -> _Req:
    if want not in ("values", "order"):
        raise ValueError(f"want must be 'values' or 'order', got {want!r}")
    if want == "order" and values is not None:
        raise ValueError(
            'want="order" returns the permutation itself; pass values with '
            'want="values", or gather them with keys[out.order()]'
        )
    # multi-key is a tuple of key columns; a 1-tuple is a single key
    multikey = isinstance(keys, tuple)
    klist = list(keys) if multikey else [keys]
    n_keys = len(klist)
    if multikey and n_keys == 0:
        raise ValueError(
            "multi-key sort needs a non-empty tuple of key arrays "
            "(got an empty tuple)"
        )
    if multikey and n_keys == 1:
        multikey, keys = False, klist[0]

    orders = tuple(order) if isinstance(order, (tuple, list)) else (order,) * n_keys
    if len(orders) != n_keys:
        raise ValueError(f"{len(orders)} order flags for {n_keys} keys")
    for o in orders:
        if o not in ("asc", "desc"):
            raise ValueError(f"order must be 'asc' or 'desc', got {o!r}")
    descending = tuple(o == "desc" for o in orders)

    if values is not None:
        values = as_tensor(values)
        check_key_dtype(values.dtype, what="values payload", x64=x64)

    # a list is an iterable of chunks (stream input), as in repro; a bare
    # list of Python scalars is one flat array
    is_iterator = not multikey and not hasattr(keys, "dtype")
    if isinstance(keys, list) and keys and not hasattr(keys[0], "dtype"):
        keys = np.asarray(keys)
        is_iterator = False
    n = n_local = dtype = None
    if multikey:
        # the columns stay where they are: the planner moves them to the
        # sort's device unless the request streams (_make_plan)
        klist = [as_tensor(k).reshape(-1) for k in klist]
        n = klist[0].shape[0]
        if any(k.shape[0] != n for k in klist):
            raise ValueError("multi-key arrays must have equal lengths")
        for k in klist:
            check_key_dtype(k.dtype, x64=x64)
        keys = klist
        dtype = klist[0].dtype
    elif not is_iterator:
        keys = as_tensor(keys)
        check_key_dtype(keys.dtype, x64=x64)
        if keys.dim() not in (1, 2):
            raise ValueError("keys must be flat, (p, n_local), or an iterator")
        n = keys.numel()
        n_local = int(keys.shape[1]) if keys.dim() == 2 else None
        dtype = keys.dtype
    if values is not None and n is not None and values.numel() != n:
        raise ValueError(f"values have {values.numel()} elements for {n} keys")
    return _Req(
        keys=keys, values=values, want=want, descending=descending,
        config=config or SortConfig(), investigator=investigator, n=n,
        n_local=n_local, dtype=dtype, multikey=multikey, is_iterator=is_iterator,
    )


def _dtype_width(dt: torch.dtype) -> int:
    return 8 * dt.itemsize


def _make_plan(req: _Req, where, limits: SortLimits | None, device, x64: bool) -> SortPlan:
    limits = limits or SortLimits()
    if limits.decode not in ("device", "host"):
        raise ValueError(
            f'SortLimits.decode must be "device" or "host", got {limits.decode!r}'
        )

    reasons: list[str] = []
    cost_source, cost_predicted = "static", None
    mesh, axis_name = None, "data"
    if isinstance(where, str):
        choice = where
        reasons.append(f"caller pinned backend {where!r}")
    elif where is not None:
        choice, mesh, axis_name = "mesh", *_mesh_of(where)
        reasons.append("caller provided (mesh, axis)" if isinstance(where, (tuple, list))
                       else "caller provided a device mesh")
    elif req.is_iterator:
        choice = "stream"
        reasons.append("iterator input: size unknown, not host-resident")
    else:
        # the size rule: the one placement the cost model may override
        if limits.stream_threshold is not None and req.n > limits.stream_threshold:
            static = ("stream", f"n={req.n} exceeds stream_threshold={limits.stream_threshold}")
        else:
            static = ("sim", f"n={req.n} fits one device program "
                             f"(stream_threshold={limits.stream_threshold})")
        choice, cost_source, cost_predicted = _consult_cost_model(req, *static, reasons)
    if choice not in BACKENDS:
        raise KeyError(f"unknown backend {choice!r}; have {sorted(BACKENDS)}")
    if choice == "mesh" and mesh is None:
        raise ValueError('backend "mesh" needs where=<Mesh> or (mesh, axis)')
    if req.is_iterator and choice != "stream":
        raise ValueError(
            f"iterator inputs can only run on the stream backend, "
            f"not {choice!r} (sim/mesh need the whole array resident)"
        )
    if req.multikey and choice != "stream":
        # the pack's rank arithmetic and the LSD gathers run on the sort's
        # device; a streamed tuple stays where it is and moves by chunks
        req.keys = [k.to(device) for k in req.keys]
    if any(req.descending):
        reasons.append("descending: order-flip key encoding (keyenc.flip)")
    group = None
    if choice == "mesh":
        from repro_torch.sharding import spec

        group = spec.axis_group(mesh, axis_name)
        if req.multikey:
            # every rank agrees on the tuple before the pack plan's reduction
            req.mesh_lengths = _mesh_preflight(req, group, None, limits, x64)[:, 0]
    multikey, packspec = (_decide_multikey(req, limits, reasons, x64, group) if req.multikey
                          else (None, None))
    if req.want == "order":
        reasons.append("argsort: provenance-index payload over the kv sort")
    n_procs = limits.n_procs
    if req.n_local is not None and choice == "sim":
        n_procs = int(req.keys.shape[0])
        reasons.append(f"(p={n_procs}, n_local) input: rows are the shards")
    elif choice == "mesh":
        n_procs = group.size
        reasons.append(f"mesh sort axis spans {n_procs} rank(s); this rank is "
                       f"coordinate {group.index} ({group.backend})")
        if group.host_staged(device):
            reasons.append(f"{group.backend} has no CUDA transport: the collectives "
                           f"are staged through the host")
    if limits.decode == "host":
        reasons.append(
            'decode="host": legacy numpy materialization (differential-'
            "testing / baseline path)"
        )
    if req.is_iterator:
        # chunk dtypes are unknown until staging: the widest the mode
        # admits (each chunk is checked at the door as it is staged)
        key_width = 64 if x64 else 32
    elif req.multikey:
        key_width = max(_dtype_width(k.dtype) for k in req.keys)
    else:
        key_width = _dtype_width(req.dtype)
    chunk_elems = limits.chunk_elems
    if choice == "stream":
        chunk_elems = _pick_chunk_elems(req, chunk_elems, reasons)
    if x64 and key_width > 32:
        reasons.append(
            f"x64 mode: {key_width}-bit key lane admitted "
            f"(sentinels/staging widen per dtype)"
        )
    return SortPlan(
        backend=choice, n_procs=n_procs, chunk_elems=chunk_elems,
        limits=limits, device=device, reasons=tuple(reasons),
        decode=limits.decode, key_width=key_width,
        multikey=multikey, packspec=packspec, x64=x64,
        cost_source=cost_source, cost_predicted=cost_predicted,
        mesh=mesh, axis_name=axis_name, group=group,
    )


def _mesh_of(where) -> tuple:
    """(mesh, axis) of a ``where`` that is not a backend name."""
    from repro_torch.sharding import spec

    mesh, axis = (where if isinstance(where, (tuple, list)) and len(where) == 2
                  else (where, "data"))
    if not spec.is_device_mesh(mesh):
        raise TypeError(
            f"where must be a backend name, a torch.distributed DeviceMesh or "
            f"(DeviceMesh, axis), not {type(where).__name__}")
    return mesh, axis


def _resolve_device(where, device) -> torch.device:
    """The sort's device (``device.resolve``). A mesh sort runs on its
    mesh's device type: None means this rank's current CUDA device, and a
    device of the other type raises ValueError."""
    if where is None or isinstance(where, str):
        return _device.resolve(device)
    mesh, _ = _mesh_of(where)
    kind = "cuda" if device is None else torch.device(device).type
    if kind != mesh.device_type:
        raise ValueError(
            f"the mesh holds {mesh.device_type!r} devices but the sort would run on "
            f"{kind!r} (device={device!r}); pass device={mesh.device_type!r}")
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# the placements the size rule arbitrates between: the mesh needs the
# caller's topology and is never chosen on cost alone
_COST_CANDIDATES = ("sim", "stream")


def _consult_cost_model(req: _Req, static_choice: str, static_reason: str, reasons: list):
    """Size-rule placement, possibly overridden by the ambient cost model.

    Returns ``(choice, cost_source, cost_predicted)``. With no tuner, or a
    cold or low-confidence store, the static choice and its reason come
    back untouched."""
    tuner = _tune.current()
    if tuner is None:
        reasons.append(static_reason)
        return static_choice, "static", None
    winner, preds = tuner.model.choose("sort", _COST_CANDIDATES, req.dtype, req.n,
                                       min_confidence=tuner.min_confidence)
    predicted = {b: {"us": p.us, "confidence": p.confidence}
                 for b, p in preds.items() if p is not None} or None
    if winner is None:
        _tune.note_plan("static")
        reasons.append(static_reason)
        return static_choice, "static", predicted
    _tune.note_plan("model")
    costs = " ".join(f"{b}~{preds[b].us:.0f}us" for b in sorted(preds))
    if winner == static_choice:
        reasons.append(f"cost model confirms the static rule ({static_reason}): {costs}")
    else:
        reasons.append(f"cost model overrides the static rule ({static_reason}): "
                       f"{costs} -> {winner} predicted fastest")
    return winner, "model", predicted


def _pick_chunk_elems(req: _Req, base: int, reasons: list) -> int:
    """Stream chunk size from the measured per-chunk sort cost: halving,
    keeping or doubling the configured chunk (clamped to [2^12, 2^22]),
    whichever has the best predicted chunk-sort throughput; the static
    size unless every candidate is predicted confidently."""
    tuner = _tune.current()
    if tuner is None:
        return base
    dtype = req.dtype if req.dtype is not None else "float32"
    scored = []
    for cand in sorted({max(1 << 12, base // 2), base, min(1 << 22, base * 2)}):
        pred = tuner.model.predict("chunk_sort", "stream", dtype, cand)
        if pred is None or pred.confidence < tuner.min_confidence:
            return base
        scored.append((cand / pred.us, cand))
    best = max(scored)[1]
    if best != base:
        reasons.append(f"cost model: chunk_elems {base} -> {best} "
                       f"(best predicted chunk-sort throughput)")
    return best


def _decide_multikey(req: _Req, limits: SortLimits, reasons: list, x64: bool, group=None):
    """Pack or LSD for a multi-key request, with its reason (``repro``'s
    words). "auto" packs whenever the tuple's measured or declared widths
    fit the mode's budget (31 bits; 63 in x64 mode); anything unpackable
    (wide tuples, unpackable dtypes, NaN floats) records why and falls
    back to the LSD passes. ``group``: a mesh sort's axis group, over
    which the pack plan's ranges are reduced, so that every rank decides
    alike."""
    k = len(req.keys)
    if limits.multikey not in ("auto", "packed", "lsd"):
        raise ValueError(
            f'SortLimits.multikey must be "auto", "packed" or "lsd", '
            f"got {limits.multikey!r}"
        )
    if limits.multikey == "lsd":
        reasons.append(
            f"{k}-key lexicographic: LSD stable-argsort passes "
            f"(SortLimits.multikey='lsd')"
        )
        return "lsd", None
    ranks: dict = {}
    spec, why = keyenc.plan_pack(req.keys, req.descending, limits.key_bits, ranks=ranks,
                                 budget=keyenc.pack_budget_bits(x64),
                                 reduce=None if group is None else group.all_max)
    if spec is not None:
        req.pack_ranks = ranks
        reasons.append(
            f"{k}-key lexicographic: packed into ONE "
            f"{keyenc.dtype_name(spec.pack_dtype)} sort ({why})"
        )
        return "packed", spec
    if limits.multikey == "packed":
        raise ValueError(
            f"SortLimits(multikey='packed') but this key tuple cannot "
            f"pack: {why}"
        )
    reasons.append(f"{k}-key lexicographic: LSD stable-argsort passes ({why})")
    return "lsd", None


# ------------------------------------------------------------- execution


def pad_grid(flat: torch.Tensor, p: int, per: int, fill) -> torch.Tensor:
    """Pack a flat tensor into the (p, per) shard grid, sentinel padded,
    spreading the real elements evenly across rows: row r takes the next
    n // p elements, plus one while r < n % p. Head-first packing would
    leave trailing rows all sentinel, a degenerate shard that makes the
    investigator funnel the tied pad range at one destination."""
    n = flat.shape[0]
    if n == 0:  # a mesh rank's empty shard: all padding
        return torch.full((p, per), fill, dtype=flat.dtype, device=flat.device)
    base, extra = divmod(n, p)
    r = torch.arange(p, device=flat.device)
    start = r * base + r.clamp(max=extra)
    take = base + (r < extra).to(torch.int64)
    pos = torch.arange(per, device=flat.device)
    grid = flat[(start[:, None] + pos).clamp(max=n - 1)]
    return grid.masked_fill_(pos >= take[:, None], fill)


def _trim_pad_counts(counts: np.ndarray, pad: int) -> np.ndarray:
    """Per-shard counts with the sentinel pads removed. Pads occupy the
    global tail, so walk shards from the back subtracting until ``pad``
    elements are gone."""
    counts = np.asarray(counts).copy()
    i = counts.shape[0] - 1
    while pad > 0 and i >= 0:
        take = min(int(counts[i]), pad)
        counts[i] -= take
        pad -= take
        i -= 1
    return counts


def _prep_single(req: _Req, x64: bool, *, n_total: int | None = None, offset: int = 0,
                 check: bool = True):
    """Encode the keys into their lane (and flip them for a descending
    payload sort) and build the payload (``x64``: the request's mode,
    which an argsort of more than 2^31 elements needs for its int64
    index). A mesh rank's argsort indexes the global array: its shard
    starts at ``offset`` of ``n_total`` elements; its keys were checked
    against the sentinel already (``check=False``).

    Returns (encoded keys, payload or None, descending, keys_only_reverse):
    keys-only descending sorts run ascending and are reversed at the end,
    which is exact and unrestricted."""
    descending = req.descending[0]
    keys = keyenc.to_lane(req.keys)
    if not req.needs_payload:
        return keys, None, descending, descending
    # a key colliding with the (encoded) padding sentinel would leak pad
    # payload into the output through the exchange's pads: refuse loudly
    # (for packed multi-key keys the packspec names the saturated tuple)
    if check:
        keyenc.check_payload_keys(req.keys, descending, packspec=req.packspec)
    if req.want == "order":
        n_total = req.n if n_total is None else n_total
        payload = torch.arange(offset, offset + req.n,
                               dtype=keyenc.provenance_dtype(n_total, x64=x64),
                               device=keys.device).reshape(keys.shape)
    else:
        payload = keyenc.to_lane(req.values).reshape(keys.shape)
    return keyenc.encode(keys, descending), payload, descending, False


def _stage(x: torch.Tensor, p: int, per: int, pad: int, dev: torch.device) -> torch.Tensor:
    """The (p, per) grid of ``x`` on ``dev``, with one copy to the device."""
    if x.dim() == 2:
        return x.to(dev)
    if pad == 0:
        return x.reshape(p, per).to(dev)
    return pad_grid(x, p, per, kops.sentinel_for(x.dtype)).to(dev)


def unpad_grid(values: np.ndarray, counts: np.ndarray, m: int) -> np.ndarray:
    """Concatenate the valid per-shard prefixes and drop the sentinel
    padding (pads sort to the global tail, so the first m are the data)."""
    parts = [values[i, : int(counts[i])] for i in range(values.shape[0])]
    return np.concatenate(parts)[:m]


def _stable_order_fix(ks: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Host twin of ``local_sort.segment_stable_kv``: reorder the argsort
    payload ascending within each run of equal sorted keys, which gives
    exactly ``np.argsort(kind="stable")``."""
    if idx.size <= 1:
        return idx
    seg = np.empty(ks.size, np.int64)
    seg[0] = 0
    np.cumsum(ks[1:] != ks[:-1], out=seg[1:])
    return idx[np.lexsort((idx, seg))]


def _stitch_bucket_ties(ks: np.ndarray, vs: np.ndarray, bucket_sizes,
                        descending: bool = False) -> np.ndarray:
    """Boundary stitch of the stream backend's device tie fix.

    With ``segment_stable=True`` the payload is exactly stable within every
    bucket (``external_merge_kv``). What the per-bucket pass cannot see is
    a run of equal keys split across bucket boundaries (the investigator
    splits tied ranges). At each bucket offset whose neighbours tie, the
    full equal-key run is found and its payload sorted ascending: within
    an equal-key run of a provenance payload, exact stability is ascending
    order. ``repro``'s host code, on numpy views of the output."""
    if not bucket_sizes or len(bucket_sizes) <= 1 or ks.size <= 1:
        return vs
    n = ks.shape[0]
    rev = ks[::-1] if descending else None
    out = None
    off = 0
    for s in bucket_sizes[:-1]:
        off += int(s)
        if off <= 0 or off >= n or ks[off - 1] != ks[off]:
            continue
        v = ks[off]
        if descending:
            lo = n - int(np.searchsorted(rev, v, side="right"))
            hi = n - int(np.searchsorted(rev, v, side="left"))
        else:
            lo = int(np.searchsorted(ks, v, side="left"))
            hi = int(np.searchsorted(ks, v, side="right"))
        if out is None:
            out = np.array(vs)
        out[lo:hi] = np.sort(out[lo:hi])
    return vs if out is None else out


def _host(t: torch.Tensor) -> np.ndarray:
    """A result grid as a host numpy array; bfloat16, which numpy lacks,
    as float32 (exact, and it compares as bfloat16 does)."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _from_host(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _from_lanes(req: _Req, ks, vs):
    """Keys (unless a packed tuple) and user values out of their lanes."""
    if not isinstance(ks, tuple):
        ks = keyenc.from_lane(ks, req.dtype)
    if req.values is not None:
        vs = keyenc.from_lane(vs, req.values.dtype)
    return ks, vs


def _grid_materialize(req: _Req, plan: SortPlan, keys_grid, values_grid, counts,
                      m, descending: bool, reverse: bool, finish=None):
    """The first ``m`` keys (a tuple of columns for a packed sort) and
    payload of the result grid, in the caller's dtypes.

    A mesh rank passes ``m`` as a callable, which gathers the global
    counts and returns its block's length, called first in the ``decode``
    span; and ``finish``, its last step, ``(keys, values) -> (keys,
    values)`` on the decoded lanes (the descending swap, the tie stitch
    across blocks), inside the ``d2h`` span, or ``decode`` for the host
    decode.

    decode="device": ``keyenc.decode_grid`` on the sort's device (the
    ``decode`` span), then the output's views (``d2h``: the keys-only
    reverse and the lanes; the output stays on the sort's device).
    decode="host": ``repro``'s legacy numpy path on a CPU copy of the grid
    (unpad, reverse or inverse flip, the tie fix on the packed keys, then
    the unpack), one ``decode`` span; CPU tensors come back."""
    want_order = req.want == "order"
    tr = req.trace
    # a mesh rank's last step sees packed keys (the tie stitch compares
    # them): the unpack then comes after it
    unpack_late = finish is not None and req.packspec is not None
    if plan.decode == "device":
        with _span(tr, "decode") as sp:
            m = m() if callable(m) else m
            ks, vs = sp.fence(keyenc.decode_grid(
                keys_grid, counts, values_grid, m=m, descending=descending and not reverse,
                want_order=want_order, packspec=None if unpack_late else req.packspec))
        with _span(tr, "d2h") as sp:
            ks = ks.flip(0) if reverse else ks
            if finish is not None:
                ks, vs = finish(ks, vs)
            if unpack_late:
                ks = keyenc.unpack_fields(ks, req.packspec)
            return sp.fence(_from_lanes(req, ks, vs))
    with _span(tr, "decode", path="host"):
        m = m() if callable(m) else m
        counts = counts.cpu().numpy()
        ks = unpad_grid(_host(keys_grid), counts, m)
        vs = None
        if values_grid is not None:
            vs = unpad_grid(_host(values_grid), counts, m)
            if want_order:
                # the tie fix sees the PACKED keys: a packed tie is an all-columns tie
                vs = _stable_order_fix(ks, vs)
            vs = _from_host(vs, values_grid.dtype)
        if reverse:
            ks = ks[::-1]
        elif descending:
            ks = keyenc.decode_np(ks, True)
        if req.packspec is not None and not unpack_late:
            ks = tuple(torch.from_numpy(c) for c in keyenc.unpack_np(ks, req.packspec))
        else:
            ks = _from_host(ks, keys_grid.dtype)
        if finish is not None:
            ks, vs = finish(ks, vs)
        if unpack_late:
            ks = tuple(torch.from_numpy(c) for c in keyenc.unpack_np(ks.numpy(), req.packspec))
        return _from_lanes(req, ks, vs)


def _measured_hook(p: int, n_local: int, group=None):
    """The measured ladder start (``overflow.measured_capacity_need``),
    only while a tuner is ambient: the cold ladder walks the geometric
    steps as before. ``group``: a mesh sort's axis group."""
    if _tune.current() is None:
        return None
    return measured_capacity_need(p, n_local, group)


def _exec_sim(req: _Req, plan: SortPlan) -> SortOutput:
    tr = req.trace
    with _span(tr, "encode"):
        p = plan.n_procs
        m = req.n
        per = req.n_local or max(1, -(-m // p))
        pad = p * per - m
        enc, payload, descending, reverse = _prep_single(req, plan.x64)
        # a keys-only float sort reads once whether its keys hold a NaN: only
        # then do the searches follow repro's probes (payload sorts refuse NaN)
        nan_keys = (payload is None and req.dtype.is_floating_point
                    and bool((req.keys != req.keys).any()))
    with _span(tr, "stage") as sp:
        xk = _stage(enc, p, per, pad, plan.device)
        xv = None if payload is None else _stage(payload, p, per, pad, plan.device)
        sp.fence((xk, xv))  # charge the copy to the device to staging
    if xv is None:
        run = lambda cfg: sim.sample_sort_sim(xk, cfg, investigator=req.investigator,
                                              nan_keys=nan_keys, trace=tr)
    else:
        run = lambda cfg: sim.sample_sort_sim_kv(xk, xv, cfg, investigator=req.investigator,
                                                 trace=tr)
    res, cfg_used, retries = run_with_capacity_retry(run, req.config, plan.limits.policy(),
                                                     measured=_measured_hook(p, per))

    kg, vg = (res.values, None) if xv is None else (res.keys, res.values)
    ks, vs = _grid_materialize(req, plan, kg, vg, res.counts, m, descending, reverse)
    return SortOutput(
        _meta(req, plan, cfg_used, retries),
        keys=ks,
        values=vs,
        counts=_trim_pad_counts(res.counts.cpu().numpy(), pad),
        overflowed=bool(res.overflowed),
        send_counts=res.send_counts.cpu().numpy(),
        raw=res,
    )


def _request_code(req: _Req, limits: SortLimits | None = None, x64: bool = False) -> int:
    """A digest of what every rank of a mesh sort must agree on; for a
    tuple also the number of keys, each column's dtype, the strategy, the
    declared widths and the pack budget."""
    vals = None if req.values is None else str(req.values.dtype)
    facts = (str(req.dtype), req.want, req.descending, vals)
    if req.multikey:
        facts += (tuple(str(k.dtype) for k in req.keys), limits.multikey, limits.key_bits,
                  keyenc.pack_budget_bits(x64))
    return zlib.crc32(repr(facts).encode())


def _mesh_preflight(req: _Req, ag, payload_error: Exception | None,
                    limits: SortLimits | None = None, x64: bool = False) -> np.ndarray:
    """One all_gather of each rank's (length, NaN, bad key, request code):
    the (p, 4) table. Every rank raises the same ValueError when the ranks
    disagree on the request or some rank's payload keys are refused, so no
    rank goes on alone into a collective that the others never reach. A
    tuple's request (``limits``, ``x64``: its strategy, widths and budget)
    is agreed at planning, before the pack plan's reduction; its columns
    are not probed for NaN here (each pass or the packed sort is)."""
    keys = req.keys
    nan = (not req.multikey and not req.needs_payload and req.dtype.is_floating_point
           and bool((keys != keys).any()))
    mine = torch.tensor([req.n, nan, payload_error is not None,
                         _request_code(req, limits, x64)], dtype=torch.int64)
    table = ag.all_gather(mine).numpy()
    if (table[:, 3] != table[0, 3]).any():
        raise ValueError("the ranks of a mesh sort disagree on the request (key dtypes, "
                         "want, orders, payload dtype; for a tuple the strategy, key_bits "
                         "and x64 mode): every rank of the axis group must make the same "
                         "call with its own shard")
    bad = np.flatnonzero(table[:, 2]).tolist()
    if bad:
        # the same text on every rank; the refusing ranks chain their cause
        raise ValueError(f"the payload sort's keys are refused on rank(s) {bad} of the axis "
                         f"group: a key there is NaN or collides with the padding sentinel "
                         f"(the cause is chained on those ranks)") from payload_error
    return table


def _mesh_reverse(ag, ks: torch.Tensor, sizes: np.ndarray) -> torch.Tensor:
    """Block r of a descending keys-only result: bucket p-1-r reversed,
    fetched from coordinate p-1-r (``sizes``: the trimmed bucket sizes)."""
    partner = ag.size - 1 - ag.index
    return ag.swap(ks, partner, int(sizes[partner])).flip(0)


def _run_length(ks: torch.Tensor) -> int:
    """Length of the leading run of keys equal to ``ks[0]``."""
    return int(torch.cumprod((ks == ks[0]).to(torch.int32), 0).sum())


def _stitch_mesh_ties(ag, ks: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """The argsort tie fix across blocks (``_stable_order_fix`` of the
    global result). The decode made each block's payload ascending within
    its runs of equal keys; a run that crosses a block boundary (the
    investigator splits tied ranges across destinations) needs its payload
    sorted as a whole and handed back in block order. One all_gather of
    each block's edges finds such runs; only then a second gathers their
    segments."""
    m = ks.shape[0]
    edges = ks[[0, -1]] if m else torch.zeros(2, dtype=ks.dtype, device=ks.device)
    info = torch.tensor([m, _run_length(ks) if m else 0, _run_length(ks.flip(0)) if m else 0])
    all_edges, all_info = ag.all_gather(edges).cpu(), ag.all_gather(info).tolist()
    # runs: lists of (block, lo, hi) segments, in global order
    runs, cur, prev = [], None, None
    for b in (i for i in range(ag.size) if all_info[i][0]):
        n_b, head, tail = all_info[b]
        if cur is not None and bool(all_edges[prev, 1] == all_edges[b, 0]):
            cur.append((b, 0, head))
            if head == n_b:  # the whole block is in the run: it goes on
                prev = b
                continue
        if cur is not None and len(cur) > 1:
            runs.append(cur)
        cur, prev = [(b, n_b - tail, n_b)], b
    if cur is not None and len(cur) > 1:
        runs.append(cur)
    if not runs:
        return vs
    # every block's run segments, head first, in one gather of equal rows
    segs = [[(lo, hi) for run in runs for blk, lo, hi in run if blk == b]
            for b in range(ag.size)]
    width = max(sum(hi - lo for lo, hi in s) for s in segs)
    mine = [vs[lo:hi] for lo, hi in segs[ag.index]]
    row = torch.cat([*mine, vs.new_zeros(width - sum(t.shape[0] for t in mine))])
    rows = ag.all_gather(row)
    vs = vs.clone()
    for run in runs:
        if all(blk != ag.index for blk, _, _ in run):
            continue
        parts, at = [], 0
        for blk, lo, hi in run:
            start = sum(h - l for l, h in segs[blk][:segs[blk].index((lo, hi))])
            parts.append(rows[blk, start:start + hi - lo])
        merged = torch.sort(torch.cat(parts)).values
        for blk, lo, hi in run:
            if blk == ag.index:
                vs[lo:hi] = merged[at:at + hi - lo]
            at += hi - lo
    return vs


def _starts(sizes) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.asarray(sizes, np.int64))])


def _even_sizes(n: int, p: int) -> np.ndarray:
    """``pad_grid``'s row lengths: the layout of ``repro``'s mesh sort of a
    flat array of n elements over p rows."""
    base, extra = divmod(n, p)
    return base + (np.arange(p) < extra).astype(np.int64)


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    """A flat tensor as (n, itemsize) bytes."""
    return t.contiguous().view(torch.uint8).reshape(t.shape[0], t.element_size())


def _tally(req: _Req, kind: str) -> None:
    req.exchanges[kind] = req.exchanges.get(kind, 0) + 1


def _mesh_take(ag, req: _Req, cols: list, sizes, idx: torch.Tensor) -> list:
    """``[c[idx] for c in cols]`` where each ``cols[j]`` is this rank's
    shard of a global array laid out by ``sizes`` (the shard length of
    each coordinate, in order) and ``idx`` holds global indices: a request
    / response exchange. Each index goes to the rank that owns it (one
    all-to-all of the counts, one of the indices), the owner gathers its
    values locally and sends them back (one all-to-all of every column's
    bytes together). Nothing is gathered whole. The results lie on
    ``idx``'s device. Counted on ``req.exchanges`` as a "take"."""
    _tally(req, "take")
    with _span(req.trace, "exchange", indexed="take"):
        dev, p = cols[0].device, ag.size
        starts = _starts(sizes)
        i = idx.to(dev).long().reshape(-1)
        owner = torch.searchsorted(torch.from_numpy(starts[1:]).to(dev), i, right=True)
        order = torch.argsort(owner, stable=True)
        local = (i - torch.from_numpy(starts[:-1]).to(dev)[owner])[order]
        send = torch.bincount(owner, minlength=p)
        recv = ag.all_to_all(send.reshape(p, 1)).reshape(p)
        send, recv = send.tolist(), recv.tolist()
        asked = ag.all_to_all_v(local, send, recv)
        rows = torch.cat([_as_rows(keyenc.take(c, asked)) for c in cols], dim=1)
        back = ag.all_to_all_v(rows, recv, send)
        got = torch.empty_like(back)
        got[order] = back
        out, at = [], 0
        for c in cols:
            w = c.element_size()
            out.append(got[:, at:at + w].contiguous().view(c.dtype).reshape(-1).to(idx.device))
            at += w
        return out


def _mesh_reblock(ag, req: _Req, t: torch.Tensor, sizes, to_sizes) -> torch.Tensor:
    """This rank's shard of a global array laid out by ``sizes``, moved to
    the layout ``to_sizes``: each rank sends every other rank the overlap
    of its range with that rank's new range (one all-to-all). Counted on
    ``req.exchanges`` as a "reblock"."""
    _tally(req, "reblock")
    with _span(req.trace, "exchange", indexed="reblock"):
        a, b = _starts(sizes).tolist(), _starts(to_sizes).tolist()
        r = ag.index

        def overlap(src: int, dst: int) -> int:  # src's old range within dst's new one
            return max(0, min(a[src + 1], b[dst + 1]) - max(a[src], b[dst]))

        return ag.all_to_all_v(t, [overlap(r, q) for q in range(ag.size)],
                               [overlap(q, r) for q in range(ag.size)])


def _exec_mesh(req: _Req, plan: SortPlan) -> SortOutput:
    """The mesh backend: this rank's shard through ``core/sample_sort.py``.

    SPMD: every rank of the axis group (``plan.group``) calls with its own
    shard, any length. The ranks all_gather their lengths and pad each
    shard with the sentinel to the longest (``per``), so that every rank
    computes the same capacities and sample counts; when the shards are
    ``pad_grid``'s split of a global array this is ``repro``'s padding.
    Each rank returns block r of the global result (``SortOutput.block``):
    the ranks' blocks concatenated in coordinate order equal ``repro``'s
    ``sort(x, where=(mesh, axis))`` of the concatenated shards. An
    argsort's indices are global (the shard's offset is the sum of the
    lengths before it), and its tie fix is stitched across blocks
    (``_stitch_mesh_ties``). A keys-only descending sort runs ascending;
    block r is then bucket p-1-r reversed, swapped between the two ranks
    (``_mesh_reverse``); the counts stay the ascending buckets'.

    ``counts`` (pads removed), ``send_counts`` (p, p), ``overflowed`` and
    ``meta.retries`` are global, gathered once; ``raw`` is this rank's row
    (``ShardSortResult`` / ``ShardSortKVResult``). A keys-only float sort
    takes ``repro``'s NaN probes on every rank if any rank holds a NaN."""
    from repro_torch.core import sample_sort

    ag, tr = plan.group, req.trace
    p, r = ag.size, ag.index
    with _span(tr, "encode"):
        err = None
        if req.needs_payload:
            try:
                keyenc.check_payload_keys(req.keys, req.descending[0], packspec=req.packspec)
            except ValueError as e:
                err = e
        facts = _mesh_preflight(req, ag, err)
        lengths = facts[:, 0]
        n_total = int(lengths.sum())
        per = max(1, int(lengths.max()))
        pad = p * per - n_total
        nan_keys = bool(facts[:, 1].any())
        enc, payload, descending, reverse = _prep_single(
            req, plan.x64, n_total=n_total, offset=int(lengths[:r].sum()), check=False)
    with _span(tr, "stage") as sp:  # this rank's row, sentinel padded to per
        xk = _stage(enc.reshape(-1), 1, per, per - req.n, plan.device)[0]
        xv = (None if payload is None
              else _stage(payload.reshape(-1), 1, per, per - req.n, plan.device)[0])
        sp.fence((xk, xv))
    if xv is None:
        run = lambda cfg: sample_sort.sample_sort_shard(  # noqa: E731
            xk, ag, cfg, investigator=req.investigator, nan_keys=nan_keys, trace=tr)
    else:
        def run(cfg):
            # kv mesh sorts keep one fused span, as repro's
            with _span(tr, "sort", phases="local_sort+splitter+exchange+merge") as sp:
                res = sp.fence(sample_sort.sample_sort_shard_kv(
                    xk, xv, ag, cfg, investigator=req.investigator))
                if tr is not None:
                    sp.counts(ag.all_gather(res.count))
            return res
    res, cfg_used, retries = run_with_capacity_retry(run, req.config, plan.limits.policy(),
                                                     measured=_measured_hook(p, per, ag))

    table = {}

    def block_length() -> int:
        """The global counts and send counts, one gather; this rank's share."""
        rows = ag.all_gather(torch.cat([res.count.reshape(1), res.send_counts]).cpu()).numpy()
        table.update(counts=_trim_pad_counts(rows[:, 0], pad), send_counts=rows[:, 1:])
        return int(table["counts"][r])

    finish = None
    if reverse:
        finish = lambda ks, vs: (_mesh_reverse(ag, ks, table["counts"]), vs)  # noqa: E731
    elif req.want == "order":
        finish = lambda ks, vs: (ks, _stitch_mesh_ties(ag, ks, vs))  # noqa: E731
    kg, vg = (res.values, None) if xv is None else (res.keys, res.values)
    ks, vs = _grid_materialize(req, plan, kg[None], None if vg is None else vg[None],
                               res.count.reshape(1), block_length,
                               descending and not reverse, False, finish=finish)
    meta = _meta(req, plan, cfg_used, retries)
    meta.n = n_total
    sizes = table["counts"][::-1] if reverse else table["counts"]
    start = int(sizes[:r].sum())
    return SortOutput(
        meta, keys=ks, values=vs, counts=table["counts"], overflowed=bool(res.overflowed),
        send_counts=table["send_counts"], raw=res,
        block=Block(index=r, size=p, start=start, stop=start + int(sizes[r])),
    )


def _host_flip(x: torch.Tensor) -> torch.Tensor:
    """``keyenc.flip`` of keys in the caller's dtype (through the lane for
    uint16 / uint32): the host encode and decode of the legacy
    ``decode="host"`` stream path."""
    return keyenc.from_lane(keyenc.flip(keyenc.to_lane(x)), x.dtype)


def _exec_stream(req: _Req, plan: SortPlan) -> SortOutput:
    """The out-of-core backend (``repro_torch.stream``): runs, partition,
    merge, with the output on the host as CPU tensors.

    Under decode="device" the order flip is fused into the pipeline: each
    chunk is flipped on the device after its copy there and each output
    chunk before its copy back, so descending keys-only results stream
    through ``chunks()``, and want="order" runs the tie fix on the device
    per bucket, stitched across buckets on the host
    (``_stitch_bucket_ties``). decode="host" keeps ``repro``'s legacy
    paths: keys-only results are reversed whole, kv keys are flipped on
    the host before and after, and the tie fix is one host pass."""
    from repro_torch.stream import StreamConfig, sort_external_kv, sort_stream

    if req.is_iterator and req.needs_payload:
        raise ValueError(
            "streamed argsort/kv over an iterator needs array inputs "
            "(the index payload must chunk with the keys)"
        )
    scfg = StreamConfig(
        chunk_elems=plan.chunk_elems, n_procs=plan.n_procs, sort=req.config,
        max_doublings=plan.limits.max_doublings, growth=plan.limits.growth, x64=plan.x64,
    )
    device_decode = plan.decode == "device"
    tr = req.trace
    descending = req.descending[0]
    with _span(tr, "encode"):
        enc, payload = req.keys, None
        if req.needs_payload:
            keyenc.check_payload_keys(req.keys, descending, packspec=req.packspec)
            if descending and not device_decode:
                enc = _host_flip(enc)
            if req.want == "order":
                if keyenc.provenance_dtype(req.n, x64=plan.x64) == torch.int32:
                    payload = range(req.n)  # int32 indices, made per chunk on the device
                else:  # past 2^31 elements: int64 indices, from the host as repro's
                    payload = torch.arange(req.n, dtype=torch.int64)
            else:
                payload = req.values.reshape(-1)
        if not req.is_iterator:
            enc = enc.reshape(-1)
    stream_desc = device_decode and descending
    reverse = descending and not device_decode and payload is None
    meta = _meta(req, plan, req.config, 0)

    # per-chunk ladder accounting: pass 1 fills stats["chunk_retries"] when
    # it runs (at materialization, or at the first chunk), and the meta is
    # updated in place
    stats: dict = {}

    def _account() -> None:
        cr = stats.get("chunk_retries")
        if cr is not None:
            meta.chunk_retries = tuple(cr)
            meta.retries, _ = ladder_totals(cr)

    def _accounted(g):
        for i, c in enumerate(g):
            if i == 0:
                _account()  # pass 1 has run once the first chunk arrives
            yield c
        _account()

    if payload is None:
        gen = _accounted(sort_stream(enc, scfg, investigator=req.investigator, stats=stats,
                                     descending=stream_desc, trace=tr, device=plan.device))
        if not reverse:
            return SortOutput(meta, chunks=gen)
        out = SortOutput(meta)

        def materialize_reversed():
            parts = list(gen)
            out.counts = np.asarray([c.shape[0] for c in parts], np.int64)
            ks = torch.cat(parts) if parts else torch.empty(0, dtype=req.dtype or torch.float32)
            return keyenc.from_lane(keyenc.to_lane(ks).flip(0), ks.dtype), None  # no uint flip

        out._materialize = materialize_reversed
        return out

    # want="order" under the device decode runs the tie fix on the device,
    # per bucket; only equal-key runs split across buckets need the stitch
    seg_stable = device_decode and req.want == "order"

    def materialize():
        ks, vs = sort_external_kv(enc, payload, scfg, investigator=req.investigator,
                                  stats=stats, descending=stream_desc, trace=tr,
                                  segment_stable=seg_stable, device=plan.device)
        _account()
        if req.want == "order":
            if seg_stable:
                vs = _stitch_bucket_ties(_host(ks), vs.numpy(), stats.get("bucket_sizes"),
                                         descending=stream_desc)
            else:
                vs = _stable_order_fix(_host(ks), vs.numpy())
            vs = torch.from_numpy(np.ascontiguousarray(vs))
        if descending and not stream_desc:
            ks = _host_flip(ks)
        return ks, vs

    return SortOutput(meta, materialize=materialize)


def _meta(req: _Req, plan: SortPlan, cfg, retries: int) -> SortMeta:
    orders = tuple("desc" if d else "asc" for d in req.descending)
    return SortMeta(
        backend=plan.backend, plan=plan, config=cfg, retries=retries, n=req.n or 0,
        want=req.want, order=orders[0] if len(orders) == 1 else orders,
        n_keys=len(req.keys) if req.multikey else 1, n_local=req.n_local,
        dtype=req.dtype, multikey=plan.multikey if req.multikey else None,
        trace=req.trace,
    )


register_backend("sim", _exec_sim, "virtual processors on one device")
register_backend("stream", _exec_stream, "out-of-core runs/partition/merge")
register_backend("mesh", _exec_mesh, "SPMD sample sort over a DeviceMesh axis")


# ------------------------------------------------------------ multi-key


def _exec_packed_multikey(req: _Req, plan: SortPlan) -> SortOutput:
    """A lexicographic sort as ONE packed single-key sort.

    The tuple fuses into one non-negative int32 or int64 key (``keyenc.pack_keys``:
    the per-key orders and rank transforms live in the bit fields), the
    backend sorts it ascending, and the decode unpacks the columns. A sort
    with a payload runs as ``want="order"`` over the packed key: the tie
    fix makes the permutation exactly stable on packed ties (all-column
    ties), and values are gathered through it, so the result equals the
    LSD passes' and ``np.lexsort``'s bit for bit.

    On the stream backend the result is lazy: keys-only under the device
    decode, ``chunks()`` yields column tuples (``keyenc.unpack_chunk``);
    otherwise the packed keys unpack on the host when materialized.

    Over the mesh every rank packs its shards with the spec reduced over
    the ranks (``_decide_multikey``) and the packed column is one mesh
    sort: block r of the packed keys and of the global permutation. The
    values of block r are gathered through it from the ranks that own
    them (``_mesh_take``)."""
    spec = plan.packspec
    mesh = plan.backend == "mesh"
    with _span(req.trace, "encode", pack=spec.describe()):
        packed = keyenc.pack_keys(req.keys, spec, ranks=req.pack_ranks,
                                  group=plan.group if mesh else None)
    sub = _Req(
        keys=packed, values=None, want="order" if req.needs_payload else "values",
        descending=(False,), config=req.config, investigator=req.investigator, n=req.n,
        n_local=None, dtype=spec.pack_dtype, packspec=spec, trace=req.trace,
    )
    out = BACKENDS[plan.backend].execute(sub, plan)
    out.meta.trace = None  # the wrapper's meta carries the trace
    meta = _meta(req, plan, out.meta.config, out.meta.retries)
    meta.n = out.meta.n  # a mesh sort's is the global length
    if mesh:
        meta.exchanges = req.exchanges  # the payload's take adds one
    wrapper = SortOutput(meta, counts=out.counts, overflowed=out.overflowed,
                         send_counts=out.send_counts, raw=out.raw, block=out.block)

    def sync() -> None:  # the stream fills its counts and ladder steps lazily
        wrapper.counts, wrapper.overflowed = out.counts, out.overflowed
        meta.retries, meta.config = out.meta.retries, out.meta.config
        meta.chunk_retries = out.meta.chunk_retries

    if out._chunks is not None and plan.decode == "device":
        def unpacked():
            for c in out.chunks():
                yield keyenc.unpack_chunk(c, spec, plan.device)
            sync()

        wrapper._chunks = unpacked()
        return wrapper

    def materialize():
        ks, perm = out.keys, out.values
        if not isinstance(ks, tuple):  # the stream's packed keys, on the host
            ks = tuple(torch.from_numpy(c) for c in keyenc.unpack_np(ks.numpy(), spec))
        sync()
        if req.want == "order":
            return ks, perm
        if req.values is not None and mesh:
            return ks, _mesh_take(plan.group, req, [req.values.to(plan.device)],
                                  req.mesh_lengths, perm)[0]
        if req.values is not None:
            return ks, keyenc.take(req.values.to(perm.device), perm)
        return ks, None

    if out._keys is None:
        wrapper._materialize = materialize
    else:
        wrapper._keys, wrapper._values = materialize()
    return wrapper


def _lsd_pass(req: _Req, plan: SortPlan, karr: torch.Tensor, descending: bool) -> SortOutput:
    """One LSD pass: the backend's exactly stable argsort of ``karr``."""
    sub = _Req(
        keys=karr, values=None, want="order", descending=(descending,),
        config=req.config, investigator=req.investigator, n=int(karr.shape[0]),
        n_local=None, dtype=karr.dtype, trace=req.trace,
    )
    out = BACKENDS[plan.backend].execute(sub, plan)
    out.meta.trace = None  # only the top-level output completes the trace
    return out


def _exec_multikey(req: _Req, plan: SortPlan) -> SortOutput:
    """A lexicographic sort: the packed pass when the planner fused the
    tuple, else LSD passes over the backend.

    LSD: perm = argsort(k_last); then for each earlier key,
    perm = perm[argsort(k[perm])]. Every pass is the backend's exactly
    stable argsort, so the composition is ``np.lexsort``'s. The gathers
    run where the passes' permutations are: on the sort's device, or on
    the CPU for decode="host" and the stream backend, whose passes return
    CPU tensors."""
    if plan.multikey == "packed":
        return _exec_packed_multikey(req, plan)
    if plan.backend == "mesh":
        return _exec_mesh_lsd(req, plan)
    klist = req.keys
    perm = _lsd_pass(req, plan, klist[-1], req.descending[-1]).values
    last = None
    for karr, desc in zip(klist[-2::-1], req.descending[-2::-1]):
        last = _lsd_pass(req, plan, keyenc.take(karr, perm.to(karr.device)), desc)
        perm = keyenc.take(perm, last.values)
    sorted_keys = tuple(keyenc.take(k, perm.to(k.device)).to(perm.device) for k in klist)
    if req.want == "order":
        values = perm
    else:
        values = None if req.values is None else keyenc.take(req.values.to(perm.device), perm)
    return SortOutput(_meta(req, plan, req.config, last.meta.retries), keys=sorted_keys,
                      values=values, counts=last.counts)


def _exec_mesh_lsd(req: _Req, plan: SortPlan) -> SortOutput:
    """LSD passes over the mesh, SPMD: ``repro``'s composition on the
    global arrays, with every gather through the permutation an indexed
    exchange between the ranks.

    The first pass sorts each rank's own shard of the last key. A pass's
    output is block r of the global permutation, sized by that pass's
    counts. The next pass's input is ``k[perm]`` in ``pad_grid``'s even
    layout, as ``repro`` shards the array it builds: the permutation moves
    to that layout (``_mesh_reblock``), the key's values are fetched from
    the ranks that own them (``_mesh_take``), and the pass's order indexes
    that layout, so ``perm[order]`` is one more take. The keys and values
    of the last permutation are fetched in one take. ``counts``,
    ``retries`` and the block are the last pass's, as ``repro`` reports
    the last pass's counts and retries."""
    ag, lengths, klist = plan.group, req.mesh_lengths, req.keys
    even = _even_sizes(int(lengths.sum()), ag.size)
    last = _lsd_pass(req, plan, klist[-1], req.descending[-1])
    perm = last.values
    for karr, desc in zip(klist[-2::-1], req.descending[-2::-1]):
        perm_even = _mesh_reblock(ag, req, perm, last.counts, even)
        last = _lsd_pass(req, plan, _mesh_take(ag, req, [karr], lengths, perm_even)[0], desc)
        perm = _mesh_take(ag, req, [perm_even], even, last.values)[0]
    cols = [*klist, *([] if req.values is None else [req.values.to(plan.device)])]
    got = _mesh_take(ag, req, cols, lengths, perm)
    values = perm if req.want == "order" else (got[-1] if req.values is not None else None)
    meta = _meta(req, plan, req.config, last.meta.retries)
    meta.n, meta.exchanges = last.meta.n, req.exchanges
    return SortOutput(meta, keys=tuple(got[:len(klist)]), values=values, counts=last.counts,
                      block=last.block)


# --------------------------------------------------------------- public


def make_plan(keys, values=None, *, order="asc", want="values", where=None,
              limits=None, config=None, investigator=True, device=None) -> SortPlan:
    dev = _resolve_device(where, device)
    x64 = _x64.effective(limits)
    req = _normalize(keys, values, order=order, want=want, config=config,
                     investigator=investigator, x64=x64)
    return _make_plan(req, where, limits, dev, x64)


def execute_request(req: _Req, plan: SortPlan, ctx=None) -> SortOutput:
    """Execute an already-normalized request on an already-made plan.

    ``sort`` plans and dispatches in one call; the sort server
    (``repro_torch.serve.sortd``) plans every request at admission
    (``serve_profile``) and dispatches it later, and both run through
    here. ``ctx`` is the request's ``obs.flight.RequestContext`` when the
    serve tier minted one: the backend is stamped on it and its
    ``trace_id`` lands on the result's meta.

    With a tuner ambient, the sort's wall time is recorded with it: at
    once for a complete (eager) result, after fencing its device; at
    materialization for a lazy one (``meta.t_start``)."""
    _SORTS_TOTAL.labels(backend=plan.backend).inc()
    if ctx is not None:
        ctx.backend = plan.backend
    if req.n == 0 and plan.backend != "mesh":  # a mesh rank's empty shard takes part
        out_dev = plan.device if plan.backend == "sim" else torch.device("cpu")
        if req.multikey:
            keys_out = tuple(torch.empty(0, dtype=k.dtype, device=out_dev) for k in req.keys)
        else:
            keys_out = torch.empty(0, dtype=req.dtype, device=out_dev)
        out = SortOutput(
            _meta(req, plan, req.config, 0),
            keys=keys_out,
            values=(torch.empty(0, dtype=torch.int32, device=out_dev)
                    if req.want == "order" else None),
            counts=np.zeros(0, np.int64),
            chunks=iter(()),
        )
        if ctx is not None:
            out.meta.trace_id = ctx.trace_id
        return out
    t0 = time.perf_counter() if _tune.current() is not None else None
    if req.multikey:
        out = _exec_multikey(req, plan)
    else:
        out = BACKENDS[plan.backend].execute(req, plan)
    if ctx is not None:
        out.meta.trace_id = ctx.trace_id
    if t0 is not None:
        if out._keys is not None:
            record_tune(out.meta, t0)
        else:
            out.meta.t_start = t0
    return out


def serve_profile(keys, values=None, *, order="asc", want="values", where=None,
                  limits=None, config=None, investigator=True, device=None):
    """Normalize and plan one serving request, and decide whether it may
    be coalesced.

    Returns ``(req, plan, batchable)``. ``batchable``: a keys-only request
    the planner routed to the sim, single-key (either order: the flip is
    part of the batched flush, ``sim.sample_sort_sim_flat``) or a packed
    tuple (the flush unpacks the columns; such requests bucket per
    ``PackSpec``, so declare ``SortLimits.key_bits`` to keep the bucket
    stable). Anything else (payloads, argsort, LSD tuples, (p, n_local)
    grids, streamed requests) runs alone through ``execute_request``."""
    dev = _resolve_device(where, device)
    x64 = _x64.effective(limits)
    req = _normalize(keys, values, order=order, want=want, config=config,
                     investigator=investigator, x64=x64)
    plan = _make_plan(req, where, limits, dev, x64)
    batchable = (
        plan.backend == "sim"
        and (not req.multikey or plan.multikey == "packed")
        and not req.needs_payload
        and req.n_local is None
        and not req.is_iterator
        and req.n > 0
    )
    return req, plan, batchable


def execute(keys, values=None, *, order="asc", want="values", where=None,
            limits=None, config=None, investigator=True, device=None) -> SortOutput:
    dev = _resolve_device(where, device)
    limits = limits or SortLimits()
    # an ambient obs.trace() block wins; else SortLimits(trace=True) builds
    # a per-sort trace that freezes when the output materializes
    tr = obs_tracing.current_trace()
    if tr is None and limits.trace and obs_tracing.enabled():
        tr = obs_tracing.Trace()
    with _span(tr, "plan"):
        x64 = _x64.effective(limits)  # the request's mode, resolved once
        req = _normalize(keys, values, order=order, want=want, config=config,
                         investigator=investigator, x64=x64)
        plan = _make_plan(req, where, limits, dev, x64)
        if tr is not None:
            tr.labels.setdefault("backend", plan.backend)
            req.trace = tr
    out = execute_request(req, plan)
    if tr is not None and out._keys is not None:
        tr.materialized()  # the output is complete: nothing lazy is left
    return out
