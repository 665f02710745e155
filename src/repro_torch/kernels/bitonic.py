"""Bitonic sorting-network kernels: CUDA wrappers and their plain twins.

Counterpart of ``repro/kernels/bitonic.py``. Each of the four wrappers
below checks its operands and calls an op of the ``repro_torch`` namespace
(``torch.library``, through ``build.define_op``: ``sort_rows``,
``sort_rows_kv``, ``merge_rows``, ``merge_rows_kv``), which launches a hand-written CUDA
kernel (``csrc/bitonic.cu``) on a CUDA tensor and runs its plain PyTorch
twin on a CPU tensor; on the meta device the op's fake gives the outputs'
shapes only (the dry run, ``launch/dryrun.py``); any other device raises.
The twin runs the same compare-exchange schedule as the Pallas
kernel (``_sort_network`` / ``_merge_network``: a static reshape to
``(rows, n_blocks, 2, j)`` and a ``torch.where`` swap per stage), so the
CPU tests hold it against ``repro`` and ``chip_smoke.py`` holds each
kernel against it on the card, both with exact equality.

Every wrapper counts its launches in ``<wrapper>.launches``: one is added
where the kernel is launched and nowhere else; ``<wrapper>.wide_launches``
counts, at the same place, the launches whose keys or values are 8 bytes
(the 64-bit instantiations). The counts are updated under a lock, since
the sort server launches from several threads.

Rows have a power-of-two length of at most 8192 (``ops`` pads). Keys and
values are int32, uint32, float32, int64 or float64 inside the kernel;
int8, int16, uint8, uint16, float16 and bfloat16 widen before it and
narrow after it, which is exact because widening preserves every
comparison, and uint64 goes through its int64 lane (the top bit flipped,
a monotone bijection). Without a tie-break the kernel carries values by
their bits, 4 or 8 bytes.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from repro_torch.kernels import build

MAX_ROW = 8192
# The row-sort kernel's layout (csrc/bitonic.cu's kElems, kMinThreads and
# kMaxThreads; tests/test_torch_kernels.py holds them equal): each thread
# holds SORT_ELEMS consecutive keys (twice that where a row would take more
# than SORT_MAX_THREADS threads), and a CTA has at least SORT_MIN_THREADS.
SORT_ELEMS = 8
SORT_MIN_THREADS = 128
SORT_MAX_THREADS = 512

_TYPE_CODES = {torch.int32: 0, torch.uint32: 1, torch.float32: 2, torch.int64: 3,
               torch.float64: 4}
_WIDEN = {
    torch.int8: torch.int32, torch.int16: torch.int32,
    torch.uint8: torch.int32, torch.uint16: torch.int32,
    torch.float16: torch.float32, torch.bfloat16: torch.float32,
}
_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = {
    "bitonic_sort_rows": [_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
    "bitonic_sort_rows_kv": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    # every merge operand is a pointer and its row stride in elements
    "bitonic_merge_rows": [_P, _L, _P, _L, _P, _L, ctypes.c_int, ctypes.c_int, _P],
    "bitonic_merge_rows_kv": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _P, _L, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
}


# ------------------------------------------------------------ plain twins


def _dir_mask(n_blocks: int, j: int, stage_span: int, device) -> torch.Tensor:
    """Ascending flag per compare block: block ``b`` covers flat indices
    [b*2j, (b+1)*2j) and is ascending iff (b*2j // span) % 2 == 0."""
    starts = torch.arange(n_blocks, dtype=torch.int32, device=device) * (2 * j)
    return (starts // stage_span) % 2 == 0


def _cmpx(keys, payloads, j: int, stage_span: int, tiebreak: int):
    """One compare-exchange stage at distance ``j`` on (R, N) keys.
    ``tiebreak`` indexes the payload that breaks key ties (-1: none)."""
    rows, n = keys.shape
    n_blocks = n // (2 * j)

    def split(x):
        x4 = x.reshape(rows, n_blocks, 2, j)
        return x4[:, :, 0, :], x4[:, :, 1, :]

    def fuse(lo, hi):
        return torch.stack([lo, hi], dim=2).reshape(rows, n)

    klo, khi = split(keys)
    asc = _dir_mask(n_blocks, j, stage_span, keys.device)[None, :, None]
    gt = klo > khi
    lt = klo < khi
    if tiebreak >= 0:
        tlo, thi = split(payloads[tiebreak])
        eq = klo == khi
        gt = gt | (eq & (tlo > thi))
        lt = lt | (eq & (tlo < thi))
    swap = torch.where(asc, gt, lt)
    new_keys = fuse(torch.where(swap, khi, klo), torch.where(swap, klo, khi))
    new_payloads = []
    for p in payloads:
        plo, phi = split(p)
        new_payloads.append(fuse(torch.where(swap, phi, plo), torch.where(swap, plo, phi)))
    return new_keys, tuple(new_payloads)


def _sort_network(keys, payloads, tiebreak: int):
    """Full bitonic sort network, ascending."""
    k = int(math.log2(keys.shape[-1]))
    for s in range(k):
        span = 1 << (s + 1)
        for sub in range(s, -1, -1):
            keys, payloads = _cmpx(keys, payloads, 1 << sub, span, tiebreak)
    return keys, payloads


def _merge_network(keys, payloads, tiebreak: int):
    """Bitonic half-cleaner stages over rows that are bitonic sequences."""
    k = int(math.log2(keys.shape[-1]))
    span = 1 << k  # one ascending run over the whole row
    for sub in range(k - 1, -1, -1):
        keys, payloads = _cmpx(keys, payloads, 1 << sub, span, tiebreak)
    return keys, payloads


# unsigned dtype -> (its signed lane, the top bit)
_LANES = {torch.uint32: (torch.int32, -(1 << 31)), torch.uint64: (torch.int64, -(1 << 63))}


def _signed(x: torch.Tensor) -> torch.Tensor:
    """uint32 / uint64 -> int32 / int64 by flipping the top bit: a
    monotone bijection (PyTorch has no comparisons on those unsigned
    dtypes)."""
    if x.dtype in _LANES:
        lane, top = _LANES[x.dtype]
        return x.view(lane) ^ top
    return x


def _unsigned(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype in _LANES:
        return (x ^ _LANES[dtype][1]).view(dtype)
    return x


def sort_rows_twin(keys, values=None, *, stable: bool = True):
    """Plain version of the (kv) sort kernel, on rows of the kernel's
    types (and uint64, by its lane)."""
    if values is None:
        out, _ = _sort_network(_signed(keys), (), tiebreak=-1)
        return _unsigned(out, keys.dtype)
    k, (v,) = _sort_network(_signed(keys), (_signed(values),), 0 if stable else -1)
    return _unsigned(k, keys.dtype), _unsigned(v, values.dtype)


def merge_rows_twin(ak, bk, av=None, bv=None, *, stable: bool = True):
    """Plain version of the (kv) merge kernel: a ++ reverse(b), then the
    half-cleaner network."""
    keys = torch.cat([_signed(ak), _signed(bk).flip(-1)], dim=-1)
    if av is None:
        out, _ = _merge_network(keys, (), tiebreak=-1)
        return _unsigned(out, ak.dtype)
    vals = torch.cat([_signed(av), _signed(bv).flip(-1)], dim=-1)
    k, (v,) = _merge_network(keys, (vals,), 0 if stable else -1)
    return _unsigned(k, ak.dtype), _unsigned(v, av.dtype)


# --------------------------------------------------------------- launching


def sort_elems(n: int) -> int:
    """Keys a thread of the row-sort kernel holds for rows of ``n``."""
    return SORT_ELEMS * (2 if n // SORT_ELEMS > SORT_MAX_THREADS else 1)


def sort_threads(n: int) -> int:
    """Threads of a row-sort CTA for rows of ``n``: one per ``sort_elems(n)``
    keys of a row, at least SORT_MIN_THREADS."""
    return max(n // sort_elems(n), SORT_MIN_THREADS)


def sort_rows_per_cta(n: int) -> int:
    """Rows of length ``n`` that one CTA of the row-sort kernel sorts."""
    return sort_threads(n) * sort_elems(n) // n


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library, with every entry point's C signature declared."""
    lib = build.load("bitonic")
    for fn, args in _ARGTYPES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.bitonic_error_string.argtypes = [ctypes.c_int]
    lib.bitonic_error_string.restype = ctypes.c_char_p
    return lib


def _launch(fn: str, *args) -> None:
    lib = _lib()
    err = getattr(lib, fn)(*args)
    if err != 0:
        msg = lib.bitonic_error_string(err).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _widen(x: torch.Tensor) -> torch.Tensor:
    """A type the kernel takes: narrow types widened, uint64 as its lane."""
    if x.dtype == torch.uint64:
        return _signed(x)
    return x.to(_WIDEN.get(x.dtype, x.dtype))


def _narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``_widen``."""
    if dtype == torch.uint64:
        return _unsigned(x, dtype)
    return x.to(dtype)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """A kernel type, contiguous, and 16-byte aligned: the row-sort kernel
    moves its elements with 16-byte accesses and refuses an unaligned
    pointer."""
    x = _widen(x).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _merge_operand(x: torch.Tensor) -> torch.Tensor:
    """A merge operand (R, n) as the kernel reads it: rows of unit stride
    at any row stride, so the merge tree's views of every other run go in
    as they are; where a thread's elements are one 16-byte piece of a row
    (n a multiple of ``sort_elems(2n)``), the start and the row stride must
    keep every piece 16-byte aligned. A copy (``_wide``) otherwise."""
    x = _widen(x)
    n = x.shape[1]
    unit = x.stride(1) == 1 or n == 1
    if n % sort_elems(2 * n) == 0:
        unit = unit and x.data_ptr() % 16 == 0 and x.stride(0) * x.element_size() % 16 == 0
    return x if unit else _wide(x)


def _check(name: str, *tensors: torch.Tensor, n_max: int = MAX_ROW) -> None:
    """Validate shapes, dtypes and devices."""
    first = tensors[0]
    if first.dim() != 2:
        raise ValueError(f"{name}: rows must be 2-D (R, N), got {tuple(first.shape)}")
    n = first.shape[1]
    if n < 1 or n & (n - 1) or n > n_max:
        raise ValueError(f"{name}: row length {n} must be a power of two <= {n_max}")
    for t in tensors:
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{name}: operands differ in shape or device")
        wide = torch.int64 if t.dtype == torch.uint64 else _WIDEN.get(t.dtype, t.dtype)
        if wide not in _TYPE_CODES:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if first.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{name}: tensors on {first.device} (want cuda, cpu or meta)")


_COUNT_LOCK = threading.Lock()


def _count(wrapper, wide: bool) -> None:
    """One launch of ``wrapper``'s kernel (``wide``: at 8 bytes)."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.wide_launches += wide


def bitonic_sort_rows(keys: torch.Tensor) -> torch.Tensor:
    """Sort each row of ``keys`` (R, N) ascending. N must be a power of 2."""
    _check("bitonic_sort_rows", keys)
    k = _widen(keys).contiguous()
    out = k if k.shape[1] == 1 or k.shape[0] == 0 else _sort_rows_op(k)
    return _narrow(out, keys.dtype)


def bitonic_sort_rows_kv(keys: torch.Tensor, values: torch.Tensor, *,
                         stable: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Key/value row sort. ``stable=True`` breaks key ties on the value,
    giving (key, value) lexicographic order."""
    _check("bitonic_sort_rows_kv", keys, values)
    k, v = _widen(keys).contiguous(), _widen(values).contiguous()
    if k.shape[1] > 1 and k.shape[0] > 0:
        k, v = _sort_rows_kv_op(k, v, bool(stable))
    return _narrow(k, keys.dtype), _narrow(v, values.dtype)


def bitonic_merge_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge row-wise sorted (R, N) + (R, N) -> sorted (R, 2N). On the card
    a and b may be views with any row stride (``_merge_operand``)."""
    _check("bitonic_merge_rows", a, b, n_max=MAX_ROW // 2)
    wa, wb = _widen(a), _widen(b)
    out = merge_rows_twin(wa, wb) if a.shape[0] == 0 else _merge_rows_op(wa, wb)
    return _narrow(out, a.dtype)


def bitonic_merge_rows_kv(ak, av, bk, bv, *, stable: bool = True):
    """Key/value merge with the same tie rule as ``bitonic_sort_rows_kv``."""
    _check("bitonic_merge_rows_kv", ak, av, bk, bv, n_max=MAX_ROW // 2)
    wide = tuple(map(_widen, (ak, av, bk, bv)))
    if ak.shape[0] == 0:
        ok, ov = merge_rows_twin(wide[0], wide[2], wide[1], wide[3], stable=stable)
    else:
        ok, ov = _merge_rows_kv_op(*wide, bool(stable))
    return _narrow(ok, ak.dtype), _narrow(ov, av.dtype)


# The four kernels as ops of the ``repro_torch`` namespace
# (``build.define_op``): a CUDA tensor launches the kernel, a CPU tensor
# runs the twin, and on the meta device each op's fake gives the outputs'
# shapes and computes nothing (the dry run, ``launch/dryrun.py``). The
# wrappers above check the operands and widen them to a kernel type first.

def _sort_rows(keys):
    if keys.device.type == "cpu":
        return sort_rows_twin(keys)
    k = _wide(keys)
    out = torch.empty_like(k)
    with torch.cuda.device(k.device):
        _launch("bitonic_sort_rows", k.data_ptr(), out.data_ptr(), k.shape[0],
                k.shape[1], _TYPE_CODES[k.dtype], _stream(k))
    _count(bitonic_sort_rows, k.element_size() == 8)
    return out


def _sort_rows_kv(keys, values, stable):
    if keys.device.type == "cpu":
        return sort_rows_twin(keys, values, stable=stable)
    k, v = _wide(keys), _wide(values)
    ok, ov = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(k.device):
        _launch("bitonic_sort_rows_kv", k.data_ptr(), v.data_ptr(), ok.data_ptr(),
                ov.data_ptr(), k.shape[0], k.shape[1], _TYPE_CODES[k.dtype],
                _TYPE_CODES[v.dtype], int(stable), _stream(k))
    _count(bitonic_sort_rows_kv, 8 in (k.element_size(), v.element_size()))
    return ok, ov


def _merge_rows(a, b):
    if a.device.type == "cpu":
        return merge_rows_twin(a, b)
    wa, wb = _merge_operand(a), _merge_operand(b)
    rows, n = wa.shape
    out = torch.empty((rows, 2 * n), dtype=wa.dtype, device=wa.device)
    with torch.cuda.device(wa.device):
        _launch("bitonic_merge_rows", wa.data_ptr(), wa.stride(0), wb.data_ptr(), wb.stride(0),
                out.data_ptr(), rows, n, _TYPE_CODES[wa.dtype], _stream(wa))
    _count(bitonic_merge_rows, wa.element_size() == 8)
    return out


def _merge_rows_kv(ak, av, bk, bv, stable):
    if ak.device.type == "cpu":
        return merge_rows_twin(ak, bk, av, bv, stable=stable)
    wak, wav, wbk, wbv = map(_merge_operand, (ak, av, bk, bv))
    rows, n = wak.shape
    ok = torch.empty((rows, 2 * n), dtype=wak.dtype, device=wak.device)
    ov = torch.empty((rows, 2 * n), dtype=wav.dtype, device=wak.device)
    with torch.cuda.device(wak.device):
        _launch("bitonic_merge_rows_kv", wak.data_ptr(), wak.stride(0), wav.data_ptr(),
                wav.stride(0), wbk.data_ptr(), wbk.stride(0), wbv.data_ptr(), wbv.stride(0),
                ok.data_ptr(), ov.data_ptr(), rows, n, _TYPE_CODES[wak.dtype],
                _TYPE_CODES[wav.dtype], int(stable), _stream(wak))
    _count(bitonic_merge_rows_kv, 8 in (wak.element_size(), wav.element_size()))
    return ok, ov


def _merged(a):
    return a.new_empty((a.shape[0], 2 * a.shape[1]))


_sort_rows_op = build.define_op("sort_rows(Tensor keys) -> Tensor", _sort_rows,
                                lambda keys: torch.empty_like(keys))
_sort_rows_kv_op = build.define_op(
    "sort_rows_kv(Tensor keys, Tensor values, bool stable) -> (Tensor, Tensor)", _sort_rows_kv,
    lambda keys, values, stable: (torch.empty_like(keys), torch.empty_like(values)))
_merge_rows_op = build.define_op("merge_rows(Tensor a, Tensor b) -> Tensor", _merge_rows,
                                 lambda a, b: _merged(a))
_merge_rows_kv_op = build.define_op(
    "merge_rows_kv(Tensor ak, Tensor av, Tensor bk, Tensor bv, bool stable) -> (Tensor, Tensor)",
    _merge_rows_kv, lambda ak, av, bk, bv, stable: (_merged(ak), _merged(av)))


KERNELS = (bitonic_sort_rows, bitonic_sort_rows_kv, bitonic_merge_rows, bitonic_merge_rows_kv)


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0."""
    with _COUNT_LOCK:
        for fn in KERNELS:
            fn.launches = fn.wide_launches = 0


reset_launches()
