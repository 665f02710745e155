"""Execution planner and backend registry (the sim backend).

Counterpart of ``repro/core/planner.py``. Placement rules, in order:
  1. ``where`` names a backend (a mesh object means the mesh backend).
  2. Inputs above ``limits.stream_threshold`` elements stream.
  3. Everything else runs on the virtual-processor simulator.

Only ``"sim"`` is registered so far. The stream and mesh backends, and
every other request this slice does not cover, raise
``NotImplementedError`` naming the ROADMAP.md item that will port it.
There is no cost model: placement is the static size rule.
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
# ROADMAP.md §1 items that port what this slice raises on
_LATER = {
    "multikey": "item 1 (multi-key sorts)",
    "x64": "item 2 (x64 mode)",
    "decode": "item 3 (host decode)",
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
    max_request_elems, multikey, key_bits: read by the serve tier and by
      multi-key sorts, neither ported yet; single-key sorts ignore them.
    decode: "device" only; "host" raises.
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

    def explain(self) -> str:
        lines = [f"repro_torch.sort plan: backend={self.backend!r}"]
        lines += [f"  - {r}" for r in self.reasons]
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

    keys: torch.Tensor  # flat (n,) or (p, n_local), caller's dtype
    values: torch.Tensor | None
    want: str  # "values" | "order"
    descending: tuple  # per-key flags
    config: SortConfig
    investigator: bool
    n: int
    n_local: int | None  # set for (p, n_local) global-view inputs
    dtype: torch.dtype

    @property
    def needs_payload(self) -> bool:
        return self.want == "order" or self.values is not None


def _normalize(keys, values, *, order, want, config, investigator) -> _Req:
    if want not in ("values", "order"):
        raise ValueError(f"want must be 'values' or 'order', got {want!r}")
    if want == "order" and values is not None:
        raise ValueError(
            'want="order" returns the permutation itself; pass values with '
            'want="values", or gather them with keys[out.order()]'
        )
    if isinstance(keys, tuple):
        if len(keys) == 0:
            raise ValueError(
                "multi-key sort needs a non-empty tuple of key arrays "
                "(got an empty tuple)"
            )
        if len(keys) > 1:
            raise _not_ported("a multi-key (tuple of arrays) sort", "multikey")
        keys = keys[0]

    orders = tuple(order) if isinstance(order, (tuple, list)) else (order,)
    if len(orders) != 1:
        raise ValueError(f"{len(orders)} order flags for 1 keys")
    for o in orders:
        if o not in ("asc", "desc"):
            raise ValueError(f"order must be 'asc' or 'desc', got {o!r}")
    descending = tuple(o == "desc" for o in orders)

    if values is not None:
        values = as_tensor(values)
        check_key_dtype(values.dtype, what="values payload")

    if isinstance(keys, list) and keys and not hasattr(keys[0], "dtype"):
        keys = np.asarray(keys)  # a bare list of Python scalars
    if not hasattr(keys, "dtype"):
        raise _not_ported("an iterator (out-of-core) input", "stream")
    keys = as_tensor(keys)
    check_key_dtype(keys.dtype)
    if keys.dim() not in (1, 2):
        raise ValueError("keys must be flat, (p, n_local), or an iterator")
    n = keys.numel()
    if values is not None and values.numel() != n:
        raise ValueError(f"values have {values.numel()} elements for {n} keys")
    return _Req(
        keys=keys, values=values, want=want, descending=descending,
        config=config or SortConfig(), investigator=investigator, n=n,
        n_local=int(keys.shape[1]) if keys.dim() == 2 else None, dtype=keys.dtype,
    )


def _make_plan(req: _Req, where, limits: SortLimits | None, device) -> SortPlan:
    limits = limits or SortLimits()
    if limits.decode not in ("device", "host"):
        raise ValueError(
            f'SortLimits.decode must be "device" or "host", got {limits.decode!r}'
        )
    if limits.decode == "host":
        raise _not_ported('decode="host"', "decode")
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
    if req.want == "order":
        reasons.append("argsort: provenance-index payload over the kv sort")
    n_procs = limits.n_procs
    if req.n_local is not None:
        n_procs = int(req.keys.shape[0])
        reasons.append(f"(p={n_procs}, n_local) input: rows are the shards")
    return SortPlan(
        backend=choice, n_procs=n_procs, chunk_elems=limits.chunk_elems,
        limits=limits, device=device, reasons=tuple(reasons),
        decode=limits.decode, key_width=8 * req.dtype.itemsize,
    )


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
    keyenc.check_payload_keys(req.keys, descending)
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


def _exec_sim(req: _Req, plan: SortPlan) -> SortOutput:
    enc, payload, descending, reverse = _prep_single(req)
    p = plan.n_procs
    m = req.n
    per = req.n_local or max(1, -(-m // p))
    pad = p * per - m
    xk = _stage(enc, p, per, pad, plan.device)
    if payload is None:
        run = lambda cfg: sim.sample_sort_sim(xk, cfg, investigator=req.investigator)
    else:
        xv = _stage(payload, p, per, pad, plan.device)
        run = lambda cfg: sim.sample_sort_sim_kv(xk, xv, cfg, investigator=req.investigator)
    res, cfg_used, retries = run_with_capacity_retry(run, req.config, plan.limits.policy())

    kg, vg = (res.values, None) if payload is None else (res.keys, res.values)
    ks, vs = keyenc.decode_grid(kg, res.counts, vg, m=m,
                                descending=descending and not reverse,
                                want_order=req.want == "order")
    if reverse:
        ks = ks.flip(0)
    if req.values is not None:
        vs = keyenc.from_lane(vs, req.values.dtype)
    return SortOutput(
        _meta(req, plan, cfg_used, retries),
        keys=keyenc.from_lane(ks, req.dtype),
        values=vs,
        counts=_trim_pad_counts(res.counts.cpu().numpy(), pad),
        overflowed=bool(res.overflowed),
        send_counts=res.send_counts.cpu().numpy(),
        raw=res,
    )


def _meta(req: _Req, plan: SortPlan, cfg, retries: int) -> SortMeta:
    return SortMeta(
        backend=plan.backend, plan=plan, config=cfg, retries=retries, n=req.n,
        want=req.want, order="desc" if req.descending[0] else "asc",
        n_local=req.n_local, dtype=req.dtype,
    )


register_backend("sim", _exec_sim, "virtual processors on one device")


def make_plan(keys, values=None, *, order="asc", want="values", where=None,
              limits=None, config=None, investigator=True, device=None) -> SortPlan:
    dev = _device.resolve(device)
    req = _normalize(keys, values, order=order, want=want, config=config,
                     investigator=investigator)
    return _make_plan(req, where, limits, dev)


def execute(keys, values=None, *, order="asc", want="values", where=None,
            limits=None, config=None, investigator=True, device=None) -> SortOutput:
    dev = _device.resolve(device)
    req = _normalize(keys, values, order=order, want=want, config=config,
                     investigator=investigator)
    plan = _make_plan(req, where, limits, dev)
    if req.n == 0:
        return SortOutput(
            _meta(req, plan, req.config, 0),
            keys=torch.empty(0, dtype=req.dtype, device=dev),
            values=(torch.empty(0, dtype=torch.int32, device=dev)
                    if req.want == "order" else None),
            counts=np.zeros(0, np.int64),
        )
    return BACKENDS[plan.backend].execute(req, plan)
