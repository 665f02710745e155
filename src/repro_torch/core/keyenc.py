"""Key encodings, multi-key packing and the decodes.

Counterpart of ``repro/core/keyenc.py``:

  * descending -> ``flip``, an order-reversing bijection per dtype (``~x``
    for integers, ``-x`` for floats); an ascending sort of flipped keys is
    a descending sort.
  * argsort    -> the payload is the flat global index (provenance); the
    kv sort is exactly stable for unique increasing payloads.
  * multi-key  -> ``plan_pack`` / ``pack_keys``: when the tuple's measured
    (or declared, ``SortLimits.key_bits``) bit widths fit the pack budget
    (31 bits; 63 in x64 mode, ``core.x64``), the columns fuse into ONE
    non-negative integer key (int32 up to 31 bits, int64 above:
    ``PackSpec.pack_dtype``), each a bit field holding its monotone
    unsigned rank (sign-xor for ints, the IEEE total-order trick for
    floats, minus the measured minimum), reversed in place for a
    descending key; else the planner runs LSD passes. The rank arithmetic
    runs in int64 on the columns' device: a 4-byte column's rank is its
    unsigned 32-bit rank; an 8-byte column's is ``repro``'s unsigned
    64-bit rank minus 2^63 (PyTorch has no unsigned 64-bit arithmetic),
    and the 63-bit budget keeps each field's ``rank - lo`` below 2^63.
    The measurement is one host read for all columns.
  * lanes      -> ``to_lane`` / ``from_lane``: uint16, uint32 and uint64
    keys and values travel as int16, int32 and int64 with the top bit
    flipped, a monotone bijection that maps the dtype's maximum onto the
    lane's maximum (so the padding sentinel stays the sentinel) and
    commutes with ``flip``. PyTorch has no comparisons, ``where`` or
    ``searchsorted`` on those unsigned dtypes. Every other admitted dtype
    is its own lane.

``stable_argsort`` is the local argsort under the MoE dispatch (an int32
iota payload over ``local_sort.local_sort_kv``).

``decode_grid`` runs on the sort's device: the compaction of the padded
(p, W) result grid, the argsort tie fix, the inverse flip and the unpack
of packed keys (``unpack_fields``). ``flip_np`` / ``decode_np`` /
``unpack_np`` are the numpy twins of ``decode="host"``; ``unpack_chunk``
unpacks one output chunk of the stream backend.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.local_sort import local_sort_kv, segment_stable_kv

_LANES = {torch.uint16: (torch.int16, -(1 << 15)), torch.uint32: (torch.int32, -(1 << 31)),
          torch.uint64: (torch.int64, -(1 << 63))}

PROVENANCE_INT32_CAP = 1 << 31
"""Largest element count an int32 provenance payload can index (read at
each call, so a test can lower it instead of allocating 2^31 elements)."""


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def to_lane(x: torch.Tensor) -> torch.Tensor:
    if x.dtype in _LANES:
        lane, top = _LANES[x.dtype]
        return x.view(lane) ^ top
    return x


def from_lane(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype in _LANES:
        _, top = _LANES[dtype]
        return (x ^ top).view(dtype)
    return x


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for every admitted dtype: uint16 and uint32 gather through
    their signed view (CUDA has no gather on them)."""
    idx = idx.long()
    if x.dtype in _LANES:
        return x.view(_LANES[x.dtype][0])[idx].view(x.dtype)
    return x[idx]


_SIGN_BITS = {torch.float64: (torch.int64, -(1 << 63)), torch.float32: (torch.int32, -(1 << 31)),
              torch.float16: (torch.int16, -(1 << 15)), torch.bfloat16: (torch.int16, -(1 << 15))}


def flip(x: torch.Tensor) -> torch.Tensor:
    """Order-reversing bijection; its own inverse. A float flips its sign
    bit, which is what ``-x`` does on the CPU (and in ``repro``), a NaN's
    included; the card's ``-x`` returns a NaN with other bits."""
    if x.dtype.is_floating_point:
        lane, sign = _SIGN_BITS[x.dtype]
        return (x.view(lane) ^ sign).view(x.dtype)
    return ~x


def flip_np(x: np.ndarray) -> np.ndarray:
    """numpy flip, for the host decode."""
    if np.issubdtype(x.dtype, np.floating):
        return -x
    return ~x


def encode(keys: torch.Tensor, descending: bool) -> torch.Tensor:
    return flip(keys) if descending else keys


def decode_np(keys: np.ndarray, descending: bool) -> np.ndarray:
    return flip_np(keys) if descending else keys


def provenance_dtype(n: int, *, x64: bool = False) -> torch.dtype:
    """The index dtype of an n-element provenance payload: int32 up to
    ``PROVENANCE_INT32_CAP`` elements; past that int64, which only x64 mode
    admits (``repro``'s TypeError otherwise: a wrapped int32 index would
    corrupt every permutation past 2^31)."""
    if n <= PROVENANCE_INT32_CAP:
        return torch.int32
    if not x64:
        raise TypeError(
            f"provenance payload for n={n} elements overflows int32 "
            f"(more than 2^31 global positions): the index payload must "
            f"be int64, which needs x64 mode. Opt in with "
            f"repro_torch.enable_x64(), REPRO_X64=1, or SortLimits(x64=True)."
        )
    return torch.int64


# ------------------------------------------------- multi-key bit packing

PACK_BUDGET_BITS = 31
"""The packed key is a non-negative integer: 31 usable bits in an int32
by default. Wider tuples run as LSD passes. Staying non-negative keeps the
packed space below the padding sentinel, except for the one saturated
value of an exactly full pack (``check_payload_keys``)."""

PACK_BUDGET_BITS_X64 = 63
"""The budget in x64 mode (``core.x64``): a non-negative int64 pack. A
tuple that fits 31 bits still packs into an int32 (``PackSpec.pack_dtype``),
so the 32-bit path is the same with the mode on or off."""

_PACK_KINDS = {
    "uint8": "uint", "uint16": "uint", "uint32": "uint", "uint64": "uint",
    "int8": "int", "int16": "int", "int32": "int", "int64": "int",
    "float32": "float", "float64": "float",
}

_SIGN32 = 1 << 31
_MASK32 = (1 << 32) - 1
_SIGN64 = 1 << 63
_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)


def pack_budget_bits(x64: bool) -> int:
    """The pack budget of a request in x64 mode or not: 63 or 31 bits."""
    return PACK_BUDGET_BITS_X64 if x64 else PACK_BUDGET_BITS


def _rank_wide(dtype: str) -> bool:
    """Does a column of this dtype rank in 64-bit space (8-byte dtypes)?"""
    return np.dtype(dtype).itemsize == 8


@dataclasses.dataclass(frozen=True)
class KeyFieldSpec:
    """How one key column maps to and from its bit field in the packed key.

    dtype: dtype name of the source column (``"int16"``, ...).
    kind: ``"uint" | "int" | "float"``: which monotone rank transform
      applies (identity / sign-bit xor / IEEE total-order bit trick).
    lo: rank-space offset subtracted before packing (the measured minimum
      rank, or the declared range's origin for ``key_bits``).
    width: field bits; 0 for constant columns.
    descending: the field is stored order-reversed (``mask - field``).
    declared: the width came from ``SortLimits.key_bits`` (a promise,
      checked at pack time) rather than from measurement.
    """

    dtype: str
    kind: str
    lo: int
    width: int
    descending: bool
    declared: bool = False


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """The recipe that fuses a key tuple into one integer key, MSB first:
    field 0 (the primary key) holds the most significant bits."""

    fields: tuple

    @property
    def total_bits(self) -> int:
        return sum(f.width for f in self.fields)

    @property
    def pack_bits(self) -> int:
        """Usable bits of the pack word this spec occupies (31 or 63)."""
        return PACK_BUDGET_BITS if self.total_bits <= PACK_BUDGET_BITS else PACK_BUDGET_BITS_X64

    @property
    def pack_dtype(self) -> torch.dtype:
        """The packed key's dtype: int32, or int64 for a wide pack."""
        return torch.int32 if self.pack_bits == PACK_BUDGET_BITS else torch.int64

    def describe(self) -> str:
        widths = "+".join(str(f.width) for f in self.fields)
        return f"widths {widths}={self.total_bits}/{self.pack_bits} bits"


def _rank(col: torch.Tensor, kind: str) -> torch.Tensor:
    """Monotone map of a column into its rank space, held in int64
    (``repro``'s ``_rank_np``). A 4-byte column: the unsigned 32-bit rank,
    floats by the IEEE total-order trick (flip every bit of a negative,
    the sign bit of a non-negative), ints plus 2^31, unsigned ints as they
    are. An 8-byte column: ``repro``'s unsigned 64-bit rank minus 2^63,
    which is the int64 itself, a float64's bits sign-folded, or a
    uint64's lane."""
    if col.element_size() == 8:
        if kind == "float":
            b = col.view(torch.int64)
            return b ^ ((b >> 63) & _INT64_MAX)
        return to_lane(col)
    if kind == "float":
        b = col.to(torch.float32).view(torch.int32).to(torch.int64) & _MASK32
        return b ^ torch.where(b >> 31 != 0, _MASK32, _SIGN32)
    if kind == "int":
        return col.to(torch.int64) + _SIGN32
    lane = to_lane(col).to(torch.int64)  # uint16/uint32: the value minus 2^15/2^31
    return lane - _LANES[col.dtype][1] if col.dtype in _LANES else lane


def _lo_rank(f: KeyFieldSpec) -> int:
    """A field's offset in ``_rank``'s space (``f.lo`` is ``repro``'s)."""
    return f.lo - _SIGN64 if _rank_wide(f.dtype) else f.lo


def _unrank(rank: torch.Tensor, f: KeyFieldSpec) -> torch.Tensor:
    """Inverse of ``_rank`` on int64 ranks (in [0, 2^32) for a 4-byte
    column)."""
    dtype = getattr(torch, f.dtype)
    if _rank_wide(f.dtype):
        if f.kind == "float":
            return (rank ^ ((rank >> 63) & _INT64_MAX)).view(torch.float64)
        return from_lane(rank, dtype)
    if f.kind == "float":
        b = rank ^ torch.where(rank >> 31 != 0, _SIGN32, _MASK32)
        b = torch.where(b >= _SIGN32, b - (1 << 32), b)  # the int32 lane, wrapped
        return b.to(torch.int32).view(torch.float32)
    if f.kind == "int":
        return (rank - _SIGN32).to(dtype)
    if dtype in _LANES:
        lane, top = _LANES[dtype]
        return from_lane((rank + top).to(lane), dtype)
    return rank.to(dtype)


def _unrank_np(rank: np.ndarray, f: KeyFieldSpec) -> np.ndarray:
    """Inverse of ``repro``'s unsigned rank (uint32, or uint64 for an
    8-byte column) on the host."""
    if _rank_wide(f.dtype):
        if f.kind == "float":
            mask = np.where(rank >> np.uint64(63), np.uint64(_SIGN64),
                            np.uint64(0xFFFFFFFFFFFFFFFF))
            return (rank ^ mask).view(np.float64)
        if f.kind == "int":
            return (rank ^ np.uint64(_SIGN64)).view(np.int64)
        return rank.astype(f.dtype)
    if f.kind == "float":
        mask = np.where(rank >> np.uint32(31), np.uint32(0x80000000), np.uint32(0xFFFFFFFF))
        return (rank ^ mask).view(np.float32)
    if f.kind == "int":
        return (rank ^ np.uint32(_SIGN32)).view(np.int32).astype(f.dtype)
    return rank.astype(f.dtype)


def plan_pack(klist, descending, key_bits=None, ranks: dict | None = None,
              budget: int = PACK_BUDGET_BITS, reduce=None):
    """Decide whether a key tuple can fuse into one packed integer sort.

    Measures each column's effective width (the bits of its rank range)
    unless ``key_bits`` declares it: a declared width ``w`` promises the
    column's values lie in ``[0, 2**w)`` (ints only) and is checked at
    pack time. Returns ``(PackSpec, reason)`` when the widths fit
    ``budget`` (31 bits, or 63 in x64 mode: ``pack_budget_bits``), else
    ``(None, reason)``; the reasons are ``repro``'s.

    The columns are walked in order, as ``repro`` walks them; the minimum,
    maximum and NaN flag of every measured column come back in one host
    read. ``ranks``: a dict that receives each measured column's rank
    tensor, for ``pack_keys`` to reuse.

    ``reduce``: a mesh sort's element-wise maximum over its axis group
    (``AxisGroup.all_max``), which every rank calls once with the same
    number of entries: the columns are then the rank's shards, and the
    statistics (minima as their bitwise complement, maxima, NaN flags) are
    the global array's, so every rank gets the same spec and reason. An
    empty shard adds the neutral elements; a column is empty only when
    every shard is.
    """
    if key_bits is not None:
        if not isinstance(key_bits, tuple):
            raise ValueError(
                f"SortLimits.key_bits must be a tuple (hashable limits), "
                f"got {type(key_bits).__name__}"
            )
        if len(key_bits) != len(klist):
            raise ValueError(
                f"SortLimits.key_bits has {len(key_bits)} entries for "
                f"{len(klist)} keys (use None entries to measure a key)"
            )
    kinds = [_PACK_KINDS.get(dtype_name(col.dtype)) for col in klist]
    stop = kinds.index(None) if None in kinds else len(klist)
    measure = [i for i in range(stop) if (key_bits is None or key_bits[i] is None)
               and (reduce is not None or klist[i].numel())]
    measured = {i: _rank(klist[i], kinds[i]) for i in measure if klist[i].numel()}
    stats = {}
    if measure:
        rows = []
        for i in measure:
            col = klist[i]
            if i not in measured:  # an empty shard: the neutral elements of the max
                rows.append(torch.tensor([_INT64_MIN, _INT64_MIN, 0, 0], device=col.device))
                continue
            r = measured[i]
            nan = (col != col).any() if kinds[i] == "float" else torch.zeros((), dtype=torch.bool,
                                                                              device=col.device)
            rows.append(torch.stack([~r.min(), r.max(), nan.to(torch.int64),
                                     torch.ones((), dtype=torch.int64, device=col.device)]))
        flat = torch.stack(rows).reshape(-1).tolist()
        if reduce is not None:
            flat = reduce(flat)
        for j, i in enumerate(measure):
            not_lo, hi, nan, present = flat[4 * j:4 * j + 4]
            if present:
                stats[i] = (~not_lo, hi, nan)
    fields = []
    for i, (col, desc) in enumerate(zip(klist, descending)):
        name = dtype_name(col.dtype)
        kind = kinds[i]
        if kind is None:
            return None, f"key {i} dtype {name} is not packable"
        declared = key_bits[i] if key_bits is not None else None
        if declared is not None:
            if kind == "float":
                raise ValueError(
                    f"SortLimits.key_bits[{i}]: declared widths are "
                    f"unsupported for {name} keys — float field widths "
                    f"are measured from the monotone rank range (pass "
                    f"None for this key)"
                )
            declared = int(declared)
            bits_max = 8 * col.element_size()
            if not 0 <= declared <= bits_max:
                raise ValueError(
                    f"SortLimits.key_bits[{i}]={declared} out of range "
                    f"[0, {bits_max}]"
                )
            lo = (_SIGN64 if bits_max == 64 else _SIGN32) if kind == "int" else 0
            fields.append(KeyFieldSpec(name, kind, lo, declared, bool(desc), declared=True))
            continue
        if i not in stats:  # an empty column (on every rank of a mesh sort)
            fields.append(KeyFieldSpec(name, kind, 0, 0, bool(desc)))
            continue
        lo, hi, nan = stats[i]
        if nan:
            return None, f"key {i} contains NaN (unsupported keys)"
        if ranks is not None and i in measured:
            ranks[i] = measured[i]
        if _rank_wide(name):  # back to repro's unsigned 64-bit rank
            lo, hi = lo + _SIGN64, hi + _SIGN64
        fields.append(KeyFieldSpec(name, kind, lo, (hi - lo).bit_length(), bool(desc)))
    spec = PackSpec(tuple(fields))
    if spec.total_bits > budget:
        widths = "+".join(str(f.width) for f in spec.fields)
        hint = ""
        if budget == PACK_BUDGET_BITS and spec.total_bits <= PACK_BUDGET_BITS_X64:
            hint = (
                " (would fit the 63-bit x64 budget: opt in with "
                "repro.enable_x64() / REPRO_X64=1 / SortLimits(x64=True))"
            )
        return None, (
            f"total width {widths}={spec.total_bits} bits exceeds the "
            f"{budget}-bit pack budget{hint}"
            f"{_float_band_hint(klist, spec, reduce)}"
        )
    return spec, spec.describe()


def _float_band_hint(klist, spec: PackSpec, reduce=None) -> str:
    """Why a float column measured wide: the exponent band of its finite
    non-zero values, and whether they cross zero (one host read; over a
    mesh, ``reduce`` takes the band and the signs across the ranks)."""
    idx = [i for i, f in enumerate(spec.fields) if f.kind == "float" and f.width]
    if not idx:
        return ""
    rows = []
    for i in idx:
        col = klist[i].reshape(-1).to(torch.float64)
        if not col.numel():  # an empty shard: the neutral elements of the max
            rows.append(torch.tensor([0, _INT64_MIN, _INT64_MIN, 0, 0], device=col.device))
            continue
        keep = torch.isfinite(col) & (col != 0.0)
        _, exp = torch.frexp(col.abs())
        exp = exp.to(torch.int64)
        rows.append(torch.stack([
            keep.any().to(torch.int64),
            ~torch.where(keep, exp, 1 << 20).min(), torch.where(keep, exp, -(1 << 20)).max(),
            (col > 0).any().to(torch.int64), (col < 0).any().to(torch.int64),
        ]))
    flat = torch.stack(rows).reshape(-1).tolist()
    if reduce is not None:
        flat = reduce(flat)
    table = [(a, ~not_lo, hi, pos & neg) for a, not_lo, hi, pos, neg
             in (flat[5 * j:5 * j + 5] for j in range(len(idx)))]
    notes = []
    for i, (any_finite, lo, hi, crosses) in zip(idx, table):
        if not any_finite:
            continue
        f = spec.fields[i]
        notes.append(
            f"key {i} ({f.dtype}) measured {f.width} rank bits from the "
            f"exponent band [2^{lo - 1}, 2^{hi - 1}]"
            + (" crossing zero" if crosses else "")
        )
    if not notes:
        return ""
    return (
        "; " + "; ".join(notes)
        + " — packing floats needs a narrow exponent band on one side "
        "of zero"
    )


def _np_scalar(col: torch.Tensor, j: int):
    """Element ``j`` of a column as a numpy scalar of its dtype."""
    return col[j:j + 1].cpu().numpy()[0]


def _from_lane_bits(v: int, dtype: torch.dtype) -> torch.Tensor:
    lane = _LANES[dtype][0] if dtype in _LANES else dtype
    return from_lane(torch.tensor([v], dtype=lane), dtype)


def _check_declared(klist, spec: PackSpec, over: dict, group=None) -> None:
    """Raise ``repro``'s ValueError for the first declared column, in
    order, holding a value outside its ``key_bits`` range, naming that
    column's first such value: one host read of a (column, [hit, value])
    table. Over a mesh every rank gathers the table in one all_gather and
    names the first value in the global order, so every rank raises the
    same error or none does."""
    rows = []
    for i, o in over.items():
        hit = o.any()
        col = klist[i].reshape(-1)
        if o.numel():
            j = torch.argmax(o.to(torch.int8)).reshape(1)
            value = to_lane(take(col, j)).to(torch.int64)[0]
        else:
            value = torch.zeros((), dtype=torch.int64, device=col.device)
        rows.append(torch.stack([hit.to(torch.int64), value]))
    table = torch.stack(rows)
    table = (table[None] if group is None else group.all_gather(table)).tolist()
    for c, i in enumerate(over):
        hits = [row[c][1] for row in table if row[c][0]]
        if hits:
            w = spec.fields[i].width
            value = _np_scalar(_from_lane_bits(hits[0], klist[i].dtype), 0)
            raise ValueError(
                f"key {i} value {value!r} does not fit "
                f"the declared SortLimits.key_bits[{i}]={w} bits (declared "
                f"keys must lie in [0, {2 ** w})); widen the "
                f"declaration or pass None to measure this key"
            )


def pack_keys(klist, spec: PackSpec, ranks: dict | None = None, group=None) -> torch.Tensor:
    """Fuse the key tuple into the packed non-negative key
    (``spec.pack_dtype``), on the columns' device: per column the rank
    minus the spec's offset, reversed within its field for a descending
    key, shifted in MSB first, in int64. A 4-byte column's field wraps
    into 32 bits, as ``repro``'s uint32 rank space wraps; an 8-byte
    column's wraps in int64 as ``repro``'s uint64 does. Declared
    (``key_bits``) widths are checked here, all columns in one host read:
    a value outside its promised range raises ``repro``'s error.
    ``ranks``: rank tensors ``plan_pack`` already computed. ``group``: a
    mesh sort's ``AxisGroup``; the columns are then the rank's shards and
    the check is the global array's (``_check_declared``)."""
    n = klist[0].reshape(-1).shape[0]
    fields, over = [], {}
    for i, (col, f) in enumerate(zip(klist, spec.fields)):
        col = col.reshape(-1)
        r = ranks.get(i) if ranks is not None else None
        if r is None:
            r = _rank(col, f.kind)
        wide = _rank_wide(f.dtype)
        field = r - _lo_rank(f) if wide else (r - f.lo) & _MASK32
        if f.declared and f.width < (64 if wide else 32):
            over[i] = (field >> f.width) != 0  # a wrapped (negative) field is over too
        fields.append(field)
    if over:
        _check_declared(klist, spec, over, group)
    acc = torch.zeros(n, dtype=torch.int64, device=klist[0].device)
    for field, f in zip(fields, spec.fields):
        if f.descending:
            field = ((1 << f.width) - 1) - field
        acc = (acc << f.width) | field
    return acc.to(spec.pack_dtype)


def unpack_fields(packed: torch.Tensor, spec: PackSpec) -> tuple:
    """Device unpack: the packed int32 or int64 key -> the original
    columns, in their dtypes. Elementwise bit surgery in int64 (shift and
    mask, the field reversal of a descending key, the inverse rank
    transform)."""
    u = packed.to(torch.int64)
    cols = []
    shift = spec.total_bits
    for f in spec.fields:
        shift -= f.width
        mask = (1 << f.width) - 1
        field = (u >> shift) & mask
        if f.descending:
            field = mask - field
        cols.append(_unrank(field + _lo_rank(f), f))
    return tuple(cols)


def unpack_np(packed: np.ndarray, spec: PackSpec) -> tuple:
    """Host twin of ``unpack_fields`` (``repro``'s, on numpy, in its
    unsigned rank spaces): the host decode's unpack, and the
    packed-sentinel error's source columns."""
    u = np.asarray(packed).astype(np.uint64)
    cols = []
    shift = spec.total_bits
    for f in spec.fields:
        shift -= f.width
        mask = (1 << f.width) - 1
        rt = np.uint64 if _rank_wide(f.dtype) else np.uint32
        field = ((u >> np.uint64(shift)) & np.uint64(mask)).astype(rt)
        if f.descending:
            field = rt(mask) - field
        cols.append(_unrank_np(field + rt(f.lo), f))
    return tuple(cols)


def unpack_chunk(packed: torch.Tensor, spec: PackSpec, device) -> tuple:
    """Unpack ONE packed output chunk of the stream backend (a CPU tensor)
    into its column tuple: ``unpack_fields`` on ``device``, then one copy
    of each column back to the host, so packed multi-key results stream
    through ``SortOutput.chunks()`` as column tuples of CPU tensors."""
    return tuple(c.cpu() for c in unpack_fields(packed.to(device), spec))


def check_payload_keys(keys: torch.Tensor, descending: bool, *, packspec=None) -> None:
    """Reject payload sorts whose keys collide with the padding sentinel.

    Ascending payload sorts cannot contain the key dtype's maximum (the
    padding sentinel); descending ones cannot contain its minimum (the
    flip maps it onto the sentinel); NaN keys order past the sentinel.
    Either way the exchange's pads would leak into the payload, so the
    sort raises the ValueError that ``repro`` raises, with the same text.
    Keys-only sorts are exempt.

    ``packspec``: ``keys`` are PACKED multi-key keys. Only an exactly full
    pack (31 bits into int32, or 63 into int64) can reach its word's
    sentinel; the error then names the packed value and the source column
    values it decodes to.
    """
    if packspec is not None:
        if packspec.total_bits < packspec.pack_bits:
            return  # the packed space tops out below the sentinel
        bad = torch.iinfo(packspec.pack_dtype).max
        hits = keys == bad
        if not bool(hits.any()):
            return
        row = int(torch.argmax(hits.to(torch.int8)))
        word = dtype_name(packspec.pack_dtype)
        src = unpack_np(np.asarray([bad], word), packspec)
        cols = ", ".join(
            f"key {i} ({f.dtype})={c[0]!r}"
            for i, (c, f) in enumerate(zip(src, packspec.fields))
        )
        raise ValueError(
            f"multi-key sort with a payload cannot represent the packed "
            f"key {bad} (it is the {word} padding sentinel: this "
            f"tuple saturates the full {packspec.total_bits}-bit pack, "
            f"first at row {row}) — source columns: {cols}. Shift or "
            f"drop those rows, force the LSD fallback with "
            f"SortLimits(multikey='lsd'), or sort keys-only (packed "
            f"keys-only sorts have no restriction)."
        )
    dt_s = dtype_name(keys.dtype)
    if keys.dtype.is_floating_point and bool((keys != keys).any()):
        raise ValueError(
            "sort with a payload cannot contain NaN keys: NaN orders "
            "after the padding sentinel, so padding would leak into the "
            "output and the payload would come back corrupted. Drop or "
            "impute the NaNs first (np.nan_to_num / boolean masking)."
        )
    if dt_s == "bfloat16":
        bad = -np.inf if descending else np.inf
    elif keys.dtype.is_floating_point:
        bad = np.dtype(dt_s).type(-np.inf if descending else np.inf)
    else:
        info = np.iinfo(dt_s)
        bad = np.dtype(dt_s).type(info.min if descending else info.max)
    target = bad.item() if isinstance(bad, np.generic) else bad
    if keys.dtype in _LANES:  # compare in the signed lane: CUDA has no unsigned ==
        lane, top = _LANES[keys.dtype]
        keys, target = to_lane(keys), target + top
    if bool((keys == target).any()):
        direction = "descending" if descending else "ascending"
        cause = (
            f"the order-flip encoding maps the {dt_s} minimum onto the "
            f"padding sentinel" if descending
            else f"it is the {dt_s} padding sentinel"
        )
        raise ValueError(
            f"{direction} sort with a payload cannot represent the key "
            f"{bad!r}: {cause}, so its payload would come back corrupted. "
            f"Shift or drop those keys first, or sort them keys-only "
            f"(no restriction without values/want='order')."
        )


def stable_argsort(keys: torch.Tensor, *, tile: int = 1024, use_pallas: bool = False):
    """Stable local argsort of a flat shard: (sorted_keys, order).

    The primitive under the MoE sorted dispatch (expert ids are the keys,
    slots the payload). The payload is an int32 iota, unique and
    increasing, so the kv sort is exactly stable and both paths give the
    same bits: ``use_pallas=True`` runs ``kernels.ops.tile_sort_kv`` (on a
    CUDA tensor the ``sort_rows_kv`` and ``merge_rows_kv`` kernels, on a
    CPU tensor their twins), ``False`` a stable ``torch.sort``.
    """
    slots = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    return local_sort_kv(keys, slots, tile=tile, use_pallas=use_pallas)


def compact_rows(grid: torch.Tensor, counts: torch.Tensor, m: int) -> torch.Tensor:
    """Front-compact a sorted, sentinel-padded (p, W) grid into its first
    ``m`` global elements; a batch (..., p, W) with counts (..., p) gives
    (..., m), each grid compacted alone.

    ``repro`` writes row r of the grid at offset starts[r] = counts[:r].sum()
    into a zeroed buffer of m + W, row after row, with
    ``dynamic_update_slice``, which clamps a start past m down to m, so such
    a row lands in the scratch tail and never reaches [0, m). The port
    gathers the same result in one pass: position i holds what the last
    row whose clamped start is <= i wrote there, or 0 when that row's W
    elements end before i. (A scatter that clipped its indices into
    [0, m) instead would write those rows' pads over the real output.)"""
    *lead, p, w = grid.shape
    rows = grid.reshape(-1, p * w)
    counts = counts.to(torch.int64).reshape(-1, p)
    starts = (torch.cumsum(counts, -1) - counts).clamp(0, m)
    pos = torch.arange(m, device=grid.device).expand(rows.shape[0], m).contiguous()
    row = torch.searchsorted(starts, pos, right=True) - 1
    off = pos - torch.gather(starts, 1, row)
    out = torch.gather(rows, 1, row * w + off.clamp(max=w - 1))
    return out.masked_fill_(off >= w, 0).reshape(*lead, m)


def decode_grid(keys_grid, counts, values_grid=None, *, m: int,
                descending: bool = False, want_order: bool = False,
                packspec: PackSpec | None = None):
    """Device-side materialization of the first ``m`` sorted elements.

    ``m`` must not exceed the staged total (every real element and front
    pad), which is the sum of ``counts``.

      descending: keys were flip-encoded; apply the inverse flip.
      want_order: the payload is the provenance index; restore exact
                  stability with the segment-stable pass (the investigator
                  splits tied ranges across destinations).
      packspec:   the grid holds PACKED multi-key keys: unpack them into
                  the tuple's columns as the last step, after the tie fix,
                  which must see the packed keys (a packed tie is an
                  all-columns tie). ``keys`` is then a tuple.

    Returns ``(keys, values-or-None)`` of shape (m,).
    """
    ks = compact_rows(keys_grid, counts, m)
    vs = None
    if values_grid is not None:
        vs = compact_rows(values_grid, counts, m)
        if want_order:
            vs = segment_stable_kv(ks, vs)
    if descending:
        ks = flip(ks)
    if packspec is not None:
        ks = unpack_fields(ks, packspec)
    return ks, vs
