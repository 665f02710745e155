"""Execution planner and backend registry (the sim backend).

Counterpart of ``repro/core/planner.py``. Placement rules, in order:
  1. ``where`` names a backend (a mesh object means the mesh backend).
  2. Inputs above ``limits.stream_threshold`` elements stream.
  3. Everything else runs on the virtual-processor simulator.

Only ``"sim"`` is registered so far. The stream and mesh backends, and
every other request the port does not cover yet, raise
``NotImplementedError`` naming the ROADMAP.md item that will port it.
There is no cost model: placement is the static size rule.

A tuple of key columns is a lexicographic multi-key sort
(``_decide_multikey``): one packed int32 sort when the columns' widths fit
31 bits (``keyenc.plan_pack``), else LSD passes of stable argsorts.
``SortLimits(decode="host")`` decodes the result grid with numpy
(``_grid_materialize``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import keyenc, sim
from repro_torch.core.overflow import OverflowPolicy, run_with_capacity_retry
from repro_torch.core.result import SortMeta, SortOutput
from repro_torch.core.splitters import SortConfig
from repro_torch.kernels import ops as kops

ADMITTED_DTYPES = (
    torch.int8, torch.int16, torch.int32, torch.uint8, torch.uint16, torch.uint32,
    torch.float16, torch.bfloat16, torch.float32,
)
# the cast remedy named in the 64-bit rejection, per offending dtype
_NEAREST_NARROW = {"int64": "int32", "uint64": "uint32", "float64": "float32"}
# ROADMAP.md §1 items that port what the port still raises on
_LATER = {
    "x64": "item 2 (x64 mode)",
    "trace": "item 4 (tracing and metrics)",
    "stream": "item 7 (stream backend)",
    "mesh": "item 9 (mesh backend)",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md §1, {_LATER[item]})"
    )


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


def check_key_dtype(dt: torch.dtype, what: str = "keys") -> None:
    """Refuse at the door what the slice cannot sort. 64-bit dtypes raise
    ``X64NotPortedError``, a TypeError as in ``repro`` (whose x64 mode is
    off by default) and a NotImplementedError naming the x64 item."""
    if dt in ADMITTED_DTYPES:
        return
    name = keyenc.dtype_name(dt)
    if dt.itemsize > 4:
        narrow = _NEAREST_NARROW.get(name, "a 32-bit dtype")
        raise keyenc.X64NotPortedError(
            f"64-bit {what} ({name}) need x64 mode, which is not ported to "
            f"repro_torch yet (ROADMAP.md §1, {_LATER['x64']}): cast to "
            f"{narrow} first (note np defaults Python ints to int64)."
        )
    raise TypeError(f"{what} of dtype {name} cannot be sorted; admitted: "
                    f"{[keyenc.dtype_name(d) for d in ADMITTED_DTYPES]}")


@dataclasses.dataclass(frozen=True)
class SortLimits:
    """Resource hints the planner dispatches on; ``repro``'s fields and
    defaults.

    n_procs: virtual processors of the sim grid for flat inputs.
    chunk_elems: device-program capacity of one stream chunk.
    stream_threshold: element count above which the planner picks the
      out-of-core backend (not ported: such sorts raise); None disables
      size-based streaming.
    max_doublings / growth / raise_on_overflow: the overflow policy (see
      ``overflow.OverflowPolicy``).
    max_request_elems: read by the serve tier, not ported yet; ignored.
    decode: "device" (default) decodes the result grid on the sort's
      device (``keyenc.decode_grid``). "host" copies the grid to the CPU
      and decodes it with numpy (``repro``'s legacy path: unpad, flip,
      tie fix, unpack), for differential testing: its outputs equal the
      device decode's bit for bit and come back as CPU tensors.
    multikey: strategy of a tuple sort. "auto" packs the tuple into one
      int32 sort when its widths fit ``keyenc.PACK_BUDGET_BITS`` (31),
      else runs LSD passes; "packed" requires packing (raises with the
      reason when the tuple cannot pack); "lsd" always runs the passes.
    key_bits: per-key declared bit widths for the packer, e.g.
      ``(4, None, 10)``: entry i promises key i's values lie in
      ``[0, 2**bits)`` (checked at pack time; ints only; None measures).
      Single-key sorts ignore it.
    trace: False only; True raises.
    x64: None or False; True raises.
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
    key_width: int = 32
    multikey: str | None = None  # "packed" | "lsd"; None for single-key
    packspec: keyenc.PackSpec | None = None  # when multikey == "packed"

    def explain(self) -> str:
        lines = [f"repro_torch.sort plan: backend={self.backend!r}"]
        lines += [f"  - {r}" for r in self.reasons]
        if self.multikey is not None:
            detail = f" ({self.packspec.describe()})" if self.packspec is not None else ""
            lines.append(f"  multikey={self.multikey}{detail}")
        lines.append(
            f"  n_procs={self.n_procs} chunk_elems={self.chunk_elems} "
            f"decode={self.decode} key_width={self.key_width} "
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

    keys: torch.Tensor | list  # flat (n,) or (p, n_local); a list of flat
    #                            columns (on the sort's device) for multi-key
    values: torch.Tensor | None
    want: str  # "values" | "order"
    descending: tuple  # per-key flags
    config: SortConfig
    investigator: bool
    n: int
    n_local: int | None  # set for (p, n_local) global-view inputs
    dtype: torch.dtype
    multikey: bool = False
    packspec: keyenc.PackSpec | None = None  # set on the packed sub-request:
    #                                          the decode unpacks the columns
    pack_ranks: dict | None = None  # rank tensors measured at plan time,
    #                                 reused by keyenc.pack_keys

    @property
    def needs_payload(self) -> bool:
        return self.want == "order" or self.values is not None


def _normalize(keys, values, *, order, want, config, investigator, device) -> _Req:
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
        check_key_dtype(values.dtype, what="values payload")

    n_local = None
    if multikey:
        # the columns move to the sort's device here: the pack's rank
        # arithmetic and the LSD gathers run there
        klist = [as_tensor(k).reshape(-1) for k in klist]
        n = klist[0].shape[0]
        if any(k.shape[0] != n for k in klist):
            raise ValueError("multi-key arrays must have equal lengths")
        for k in klist:
            check_key_dtype(k.dtype)
        keys = [k.to(device) for k in klist]
        dtype = klist[0].dtype
    else:
        if isinstance(keys, list) and keys and not hasattr(keys[0], "dtype"):
            keys = np.asarray(keys)  # a bare list of Python scalars
        if not hasattr(keys, "dtype"):
            raise _not_ported("an iterator (out-of-core) input", "stream")
        keys = as_tensor(keys)
        check_key_dtype(keys.dtype)
        if keys.dim() not in (1, 2):
            raise ValueError("keys must be flat, (p, n_local), or an iterator")
        n = keys.numel()
        n_local = int(keys.shape[1]) if keys.dim() == 2 else None
        dtype = keys.dtype
    if values is not None and values.numel() != n:
        raise ValueError(f"values have {values.numel()} elements for {n} keys")
    return _Req(
        keys=keys, values=values, want=want, descending=descending,
        config=config or SortConfig(), investigator=investigator, n=n,
        n_local=n_local, dtype=dtype, multikey=multikey,
    )


def _make_plan(req: _Req, where, limits: SortLimits | None, device) -> SortPlan:
    limits = limits or SortLimits()
    if limits.decode not in ("device", "host"):
        raise ValueError(
            f'SortLimits.decode must be "device" or "host", got {limits.decode!r}'
        )
    if limits.trace:
        raise _not_ported("SortLimits(trace=True)", "trace")
    if limits.x64:
        raise _not_ported("SortLimits(x64=True)", "x64")

    reasons: list[str] = []
    if where is not None:
        choice = where if isinstance(where, str) else "mesh"
        reasons.append(f"caller pinned backend {choice!r}")
    elif limits.stream_threshold is not None and req.n > limits.stream_threshold:
        choice = "stream"
        reasons.append(f"n={req.n} exceeds stream_threshold={limits.stream_threshold}")
    else:
        choice = "sim"
        reasons.append(
            f"n={req.n} fits one device program "
            f"(stream_threshold={limits.stream_threshold})"
        )
    if choice not in BACKENDS:
        if choice in ("stream", "mesh"):
            raise _not_ported(f"the {choice} backend", choice)
        raise KeyError(f"unknown backend {choice!r}; have {sorted(BACKENDS)}")
    if any(req.descending):
        reasons.append("descending: order-flip key encoding (keyenc.flip)")
    multikey, packspec = (_decide_multikey(req, limits, reasons) if req.multikey
                          else (None, None))
    if req.want == "order":
        reasons.append("argsort: provenance-index payload over the kv sort")
    n_procs = limits.n_procs
    if req.n_local is not None:
        n_procs = int(req.keys.shape[0])
        reasons.append(f"(p={n_procs}, n_local) input: rows are the shards")
    if limits.decode == "host":
        reasons.append(
            'decode="host": legacy numpy materialization (differential-'
            "testing / baseline path)"
        )
    columns = req.keys if req.multikey else [req.keys]
    return SortPlan(
        backend=choice, n_procs=n_procs, chunk_elems=limits.chunk_elems,
        limits=limits, device=device, reasons=tuple(reasons),
        decode=limits.decode, key_width=max(8 * k.element_size() for k in columns),
        multikey=multikey, packspec=packspec,
    )


def _decide_multikey(req: _Req, limits: SortLimits, reasons: list):
    """Pack or LSD for a multi-key request, with its reason (``repro``'s
    words). "auto" packs whenever the tuple's measured or declared widths
    fit the 31-bit budget; anything unpackable (wide tuples, unpackable
    dtypes, NaN floats) records why and falls back to the LSD passes."""
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
    spec, why = keyenc.plan_pack(req.keys, req.descending, limits.key_bits, ranks=ranks)
    if spec is not None:
        req.pack_ranks = ranks
        reasons.append(
            f"{k}-key lexicographic: packed into ONE "
            f"{keyenc.dtype_name(keyenc.PACK_DTYPE)} sort ({why})"
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


def _prep_single(req: _Req):
    """Encode the keys into their lane (and flip them for a descending
    payload sort) and build the payload.

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
    keyenc.check_payload_keys(req.keys, descending, packspec=req.packspec)
    if req.want == "order":
        payload = torch.arange(req.n, dtype=keyenc.provenance_dtype(req.n),
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


def _host(t: torch.Tensor) -> np.ndarray:
    """A result grid as a host numpy array; bfloat16, which numpy lacks,
    as float32 (exact, and it compares as bfloat16 does)."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _from_host(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _grid_materialize(req: _Req, plan: SortPlan, keys_grid, values_grid, counts,
                      m: int, descending: bool, reverse: bool):
    """The first ``m`` keys (a tuple of columns for a packed sort) and
    payload of the result grid, in lane dtypes.

    decode="device": ``keyenc.decode_grid`` on the sort's device (and the
    keys-only reverse). decode="host": ``repro``'s legacy numpy path on a
    CPU copy of the grid (unpad, reverse or inverse flip, the tie fix on
    the packed keys, then the unpack); CPU tensors come back."""
    want_order = req.want == "order"
    if plan.decode == "device":
        ks, vs = keyenc.decode_grid(keys_grid, counts, values_grid, m=m,
                                    descending=descending and not reverse,
                                    want_order=want_order, packspec=req.packspec)
        return (ks.flip(0) if reverse else ks), vs
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
    if req.packspec is not None:
        return tuple(torch.from_numpy(c) for c in keyenc.unpack_np(ks, req.packspec)), vs
    return _from_host(ks, keys_grid.dtype), vs


def _exec_sim(req: _Req, plan: SortPlan) -> SortOutput:
    enc, payload, descending, reverse = _prep_single(req)
    p = plan.n_procs
    m = req.n
    per = req.n_local or max(1, -(-m // p))
    pad = p * per - m
    # a keys-only float sort reads once whether its keys hold a NaN: only
    # then do the searches follow repro's probes (payload sorts refuse NaN)
    nan_keys = (payload is None and req.dtype.is_floating_point
                and bool((req.keys != req.keys).any()))
    xk = _stage(enc, p, per, pad, plan.device)
    if payload is None:
        run = lambda cfg: sim.sample_sort_sim(xk, cfg, investigator=req.investigator,
                                              nan_keys=nan_keys)
    else:
        xv = _stage(payload, p, per, pad, plan.device)
        run = lambda cfg: sim.sample_sort_sim_kv(xk, xv, cfg, investigator=req.investigator)
    res, cfg_used, retries = run_with_capacity_retry(run, req.config, plan.limits.policy())

    kg, vg = (res.values, None) if payload is None else (res.keys, res.values)
    ks, vs = _grid_materialize(req, plan, kg, vg, res.counts, m, descending, reverse)
    if not isinstance(ks, tuple):
        ks = keyenc.from_lane(ks, req.dtype)
    if req.values is not None:
        vs = keyenc.from_lane(vs, req.values.dtype)
    return SortOutput(
        _meta(req, plan, cfg_used, retries),
        keys=ks,
        values=vs,
        counts=_trim_pad_counts(res.counts.cpu().numpy(), pad),
        overflowed=bool(res.overflowed),
        send_counts=res.send_counts.cpu().numpy(),
        raw=res,
    )


def _meta(req: _Req, plan: SortPlan, cfg, retries: int) -> SortMeta:
    orders = tuple("desc" if d else "asc" for d in req.descending)
    return SortMeta(
        backend=plan.backend, plan=plan, config=cfg, retries=retries, n=req.n,
        want=req.want, order=orders[0] if len(orders) == 1 else orders,
        n_keys=len(req.keys) if req.multikey else 1, n_local=req.n_local,
        dtype=req.dtype, multikey=plan.multikey if req.multikey else None,
    )


register_backend("sim", _exec_sim, "virtual processors on one device")


# ------------------------------------------------------------ multi-key


def _exec_packed_multikey(req: _Req, plan: SortPlan) -> SortOutput:
    """A lexicographic sort as ONE packed single-key sort.

    The tuple fuses into one non-negative int32 key (``keyenc.pack_keys``:
    the per-key orders and rank transforms live in the bit fields), the
    backend sorts it ascending, and the decode unpacks the columns. A sort
    with a payload runs as ``want="order"`` over the packed key: the tie
    fix makes the permutation exactly stable on packed ties (all-column
    ties), and values are gathered through it, so the result equals the
    LSD passes' and ``np.lexsort``'s bit for bit."""
    spec = plan.packspec
    packed = keyenc.pack_keys(req.keys, spec, ranks=req.pack_ranks)
    sub = _Req(
        keys=packed, values=None, want="order" if req.needs_payload else "values",
        descending=(False,), config=req.config, investigator=req.investigator, n=req.n,
        n_local=None, dtype=keyenc.PACK_DTYPE, packspec=spec,
    )
    out = BACKENDS[plan.backend].execute(sub, plan)
    perm = out.values
    values = None
    if req.want == "order":
        values = perm
    elif req.values is not None:
        values = keyenc.take(req.values.to(perm.device), perm)
    return SortOutput(
        _meta(req, plan, out.meta.config, out.meta.retries), keys=out.keys, values=values,
        counts=out.counts, overflowed=out.overflowed, send_counts=out.send_counts, raw=out.raw,
    )


def _exec_multikey(req: _Req, plan: SortPlan) -> SortOutput:
    """A lexicographic sort: the packed pass when the planner fused the
    tuple, else LSD passes over the backend.

    LSD: perm = argsort(k_last); then for each earlier key,
    perm = perm[argsort(k[perm])]. Every pass is the backend's exactly
    stable argsort, so the composition is ``np.lexsort``'s. The gathers
    run on the sort's device (on the CPU for decode="host", whose passes
    return CPU tensors)."""
    if plan.multikey == "packed":
        return _exec_packed_multikey(req, plan)
    backend = BACKENDS[plan.backend]

    def sub_sort(karr: torch.Tensor, descending: bool) -> SortOutput:
        sub = _Req(
            keys=karr, values=None, want="order", descending=(descending,),
            config=req.config, investigator=req.investigator, n=int(karr.shape[0]),
            n_local=None, dtype=karr.dtype,
        )
        return backend.execute(sub, plan)

    klist = req.keys
    perm = sub_sort(klist[-1], req.descending[-1]).values
    last = None
    for karr, desc in zip(klist[-2::-1], req.descending[-2::-1]):
        last = sub_sort(keyenc.take(karr, perm.to(karr.device)), desc)
        perm = keyenc.take(perm, last.values)
    sorted_keys = tuple(keyenc.take(k, perm.to(k.device)).to(perm.device) for k in klist)
    if req.want == "order":
        values = perm
    else:
        values = None if req.values is None else keyenc.take(req.values.to(perm.device), perm)
    return SortOutput(_meta(req, plan, req.config, last.meta.retries), keys=sorted_keys,
                      values=values, counts=last.counts)


# --------------------------------------------------------------- public


def make_plan(keys, values=None, *, order="asc", want="values", where=None,
              limits=None, config=None, investigator=True, device=None) -> SortPlan:
    dev = _device.resolve(device)
    req = _normalize(keys, values, order=order, want=want, config=config,
                     investigator=investigator, device=dev)
    return _make_plan(req, where, limits, dev)


def execute(keys, values=None, *, order="asc", want="values", where=None,
            limits=None, config=None, investigator=True, device=None) -> SortOutput:
    dev = _device.resolve(device)
    req = _normalize(keys, values, order=order, want=want, config=config,
                     investigator=investigator, device=dev)
    plan = _make_plan(req, where, limits, dev)
    if req.n == 0:
        if req.multikey:
            keys_out = tuple(torch.empty(0, dtype=k.dtype, device=dev) for k in req.keys)
        else:
            keys_out = torch.empty(0, dtype=req.dtype, device=dev)
        return SortOutput(
            _meta(req, plan, req.config, 0),
            keys=keys_out,
            values=(torch.empty(0, dtype=torch.int32, device=dev)
                    if req.want == "order" else None),
            counts=np.zeros(0, np.int64),
        )
    if req.multikey:
        return _exec_multikey(req, plan)
    return BACKENDS[plan.backend].execute(req, plan)
