"""The cases of tests/test_torch_x64.py: inputs made from seeds with numpy
and each sort's arguments in plain Python, so that ``repro`` (in the
reference subprocess, tests/torch_x64_reference.py) and ``repro_torch``
(in the test) build their own limits and configs from the same dicts.

A case is a dict: ``keys`` (an array, or a tuple of columns), ``values``
(or None), ``kw`` (order / want / where), ``limits`` and ``config``
(``SortLimits`` / ``SortConfig`` fields), ``cap`` (a lowered
``keyenc.PROVENANCE_INT32_CAP``, or None) and ``plan`` (also record the
plan's reasons).
"""
from __future__ import annotations

from itertools import product

import numpy as np

N = 3000
WIDE = ("int64", "uint64", "float64")


def column(dtype: str, n: int, seed: int, *, payload_safe: bool = True) -> np.ndarray:
    """Keys of a 64-bit dtype over its whole range, with duplicates (a
    quarter of the values drawn from a pool of 64) and, for float64,
    +-0.0 and huge exponents; ``payload_safe`` keeps the dtype's extremes
    (+-inf for float64) out, so payload sorts are admitted both ways."""
    rng = np.random.default_rng(seed)
    if dtype == "float64":
        x = rng.normal(0.0, 1.0, n) * 10.0 ** rng.integers(-300, 300, n)
        x[::7], x[::11] = 0.0, -0.0
        if not payload_safe:
            x[::13], x[::17] = np.inf, -np.inf
    else:
        info = np.iinfo(dtype)
        lo, hi = int(info.min) + payload_safe, int(info.max) - payload_safe
        x = rng.integers(lo, hi, n, dtype=dtype, endpoint=True)
        if not payload_safe:
            x[::13], x[::17] = info.max, info.min
    pool = x[rng.integers(0, n, 64)]
    dup = rng.random(n) < 0.25
    x[dup] = pool[rng.integers(0, 64, int(dup.sum()))]
    return x


def ts_shard(n: int, seed: int):
    """An epoch-seconds int64 timestamp (a 34-bit spread) and an int32
    shard id: 42 bits, over the 31-bit budget, inside 63."""
    rng = np.random.default_rng(seed)
    ts = np.int64(17 * 10**8) + rng.permutation(n).astype(np.int64) * np.int64((1 << 34) // n)
    return ts, rng.integers(0, 200, n).astype(np.int32)


def saturated(n: int = 64):
    """An exactly 63-bit pack whose first row saturates every field: it
    packs to the int64 padding sentinel."""
    c0, c1 = np.zeros(n, np.uint64), np.zeros(n, np.uint32)
    c0[0], c0[1] = np.uint64(2**32 - 1), np.uint64(1)
    c1[0], c1[1] = np.uint32(2**31 - 1), np.uint32(1)
    return c0, c1


def _case(keys, values=None, *, limits=None, config=None, cap=None, plan=False, **kw):
    lim = dict(n_procs=4, chunk_elems=1 << 11, stream_threshold=None)
    lim.update(limits or {})
    cfg = dict(tile=512, use_pallas=False)
    cfg.update(config or {})
    return dict(keys=keys, values=values, kw=kw, limits=lim, config=cfg, cap=cap, plan=plan)


def _matrix():
    """int64 / uint64 / float64 x sim / stream x keys / payload / order; the
    decode and the order alternate so that each dtype meets both of each;
    a sim argsort and a streamed payload sort run the Pallas kernels
    (``repro``'s in interpret mode, about 4 s each on the CPU; the kernels
    themselves are held at every row length by ``twin_cases``)."""
    out = {}
    for i, (dt, where, want) in enumerate(product(WIDE, ("sim", "stream"), ("keys", "payload",
                                                                            "order"))):
        decode = ("device", "host")[i % 2]
        order = ("asc", "desc")[(i // 2) % 2]
        pallas = (dt, where, want) in {("float64", "sim", "order"), ("uint64", "stream", "payload")}
        keys = column(dt, N, i, payload_safe=want != "keys")
        values = None
        if want == "payload":
            vt = ("float64", "int64", "uint64", "int32")[i % 4]
            values = column(vt, N, 100 + i)
        out[f"{dt}-{where}-{want}-{decode}-{order}-pallas{int(pallas)}"] = _case(
            keys, values, order=order, want="order" if want == "order" else "values",
            where=where, limits=dict(decode=decode), config=dict(use_pallas=pallas))
    return out


def _nan(pallas: bool):
    rng = np.random.default_rng(7)
    x = rng.normal(size=N)
    x[::9], x[::10] = 0.0, -0.0
    x[rng.random(N) < 0.05] = np.nan
    return _case(x, where="sim", config=dict(use_pallas=pallas))


def cases() -> dict:
    ts, shard = ts_shard(1500, 3)
    wide = column("int64", 1500, 4, payload_safe=False)
    c = _matrix()
    c.update({
        "packed ts/shard sim order": _case((ts, shard), where="sim", want="order", plan=True),
        "packed ts/shard stream order": _case((ts, shard), where="stream", want="order",
                                              limits=dict(decode="host")),
        "packed ts/shard desc payload": _case((ts, shard), column("float64", 1500, 5),
                                              where="sim", order=("desc", "asc")),
        "over budget lsd": _case((wide, shard), where="sim", plan=True),
        "saturated 63 keys-only": _case(saturated(), where="sim", plan=True),
        "saturated 63 payload": _case(saturated(), np.arange(64, dtype=np.int32), where="sim"),
        "saturated 63 order": _case(saturated(), where="sim", want="order"),
        "float64 NaN keys-only": _nan(False),
        "float64 NaN keys-only pallas": _nan(True),
        "cap 16 order sim": _case(column("int64", 20, 6), where="sim", want="order", cap=16),
        "cap 16 order stream": _case(column("float64", 40, 7), where="stream", want="order",
                                     cap=16, limits=dict(chunk_elems=16)),
        "x64=False pins 32 bits": _case(column("int64", 64, 8), where="sim",
                                        limits=dict(x64=False)),
        "x64=False float64 values": _case(np.arange(64, dtype=np.float32),
                                          column("float64", 64, 9), where="sim",
                                          limits=dict(x64=False)),
        "narrow pair under the mode": _case(
            (np.random.default_rng(10).integers(0, 1 << 10, 257).astype(np.int16),
             np.random.default_rng(11).integers(-50, 50, 257).astype(np.int8)),
            order=("asc", "desc"), where="sim", plan=True),
        "int64 iterator stream": _case(iter_of(column("int64", N, 12)), where="stream"),
    })
    return c


def iter_of(x: np.ndarray, piece: int = 700) -> list:
    """``x`` as a list of pieces: an iterator input, which streams."""
    return [x[i:i + piece] for i in range(0, x.shape[0], piece)]


def twin_cases() -> dict:
    """The four kernels at 8 bytes, one row length 2 .. 8192 each (merges
    into it), turning through the kernels, the key types (uint64 as
    itself: the wrappers take its lane) and the value types: name ->
    (kernel, arrays, stable)."""
    out = {}
    kinds = ("sort", "sort_kv", "merge", "merge_kv")
    values = ("int32", "int64", "float64", "uint64", "float32", "uint32")
    for log_n in range(1, 14):
        kind = kinds[log_n % 4]
        kd, vd = WIDE[log_n % 3], values[log_n % 6]
        n, rows = 1 << log_n, 3 if log_n < 12 else 1
        stable = log_n % 2 == 0
        if kind.startswith("sort"):
            arrays = (column(kd, rows * n, log_n, payload_safe=False).reshape(rows, n),)
        else:
            half = [np.sort(column(kd, rows * n // 2, 10 * log_n + i, payload_safe=False)
                            .reshape(rows, n // 2), axis=-1) for i in range(2)]
            arrays = tuple(half)
        if kind.endswith("kv"):
            v = column(vd, rows * n, 20 + log_n).reshape(rows, -1)
            if kind == "sort_kv":
                arrays = (arrays[0], v)
            else:
                arrays = (arrays[0], v[:, : n // 2], arrays[1], v[:, n // 2:])
        out[f"{kind} {kd}/{vd if kind.endswith('kv') else '-'} N={n} stable={stable}"] = (
            kind, arrays, stable)
    return out
