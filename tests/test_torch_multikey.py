"""Multi-key sorts of ``repro_torch`` against ``repro`` on the sim backend.

The same numpy key tuples go through ``repro.sort(..., where="sim")`` and
``repro_torch.sort(..., device="cpu")``: both strategies (one packed int32
sort, LSD passes), per-key orders, values, ``want="order"``, declared
``key_bits``, and the errors, compared bit for bit (float columns by their
bits). The pack recipe itself (``keyenc.plan_pack`` / ``pack_keys`` /
``unpack_*``) is held to ``repro``'s on the same columns. A seeded fuzzer
holds port packed == port LSD == ``np.lexsort`` == ``repro``.

-0.0: the packed float transform orders -0.0 below +0.0 (in both
packages), while the LSD passes and ``np.lexsort`` treat them as equal.
So ±0.0 columns are held packed against ``repro`` packed and LSD against
``repro`` LSD; the cross-strategy and ``np.lexsort`` checks run without
-0.0 (the fuzzer's columns fold it, as ``fuzz_harness`` does).
"""
import numpy as np
import pytest
import torch

import fuzz_harness
import repro
import repro_torch
from repro.core import keyenc as jkeyenc
from repro_torch.core import keyenc
from torch_parity import (assert_bits_equal, assert_multikey_equal, make_keys, port_limits,
                          port_np, sort_both_raising, tt)

RNG = np.random.default_rng(17)
CFG = repro.SortConfig(use_pallas=False, capacity_factor=2.0)


def _lim(**kw):
    return repro.SortLimits(n_procs=4, **kw)


def _tuple(kind: str, n: int):
    """Key tuples: (columns, per-key orders). Names say how "auto" runs."""
    rng = np.random.default_rng(len(kind) * 1000 + n)
    if kind == "int8+int16 packed":
        cols = (rng.integers(-8, 8, n).astype(np.int8), rng.integers(-300, 300, n).astype(np.int16))
        return cols, ("desc", "asc")
    if kind == "uint8+float32+uint16 packed":
        pool = np.array([-2.0, -1.75, -1.5, -1.25, -1.0], np.float32)
        cols = (rng.integers(0, 8, n).astype(np.uint8), pool[rng.integers(0, 5, n)],
                rng.integers(65528, 65535, n).astype(np.uint16))  # 3 + 23 + 3 bits
        return cols, ("asc", "desc", "desc")
    if kind == "int16+uint32+float32 lsd":
        cols = (rng.integers(-5, 5, n).astype(np.int16),
                rng.integers(0, 2**32 - 1, n, dtype=np.uint32),
                make_keys(rng, n, "float32", zeros=False))
        return cols, ("asc", "desc", "asc")
    if kind == "float16+int8 lsd":
        cols = (make_keys(rng, n, "float16", distinct=9), rng.integers(-3, 3, n).astype(np.int8))
        return cols, ("desc", "asc")
    if kind == "+-0.0 float32+int8 packed":
        f = rng.integers(0, 2, n).astype(np.float32)  # 30 rank bits from -0.0 to 1.0
        f[f == 0] = np.where(rng.random((f == 0).sum()) < 0.5, 0.0, -0.0)
        return (f, rng.integers(0, 2, n).astype(np.int8)), ("asc", "desc")
    raise ValueError(kind)


TUPLES = ["int8+int16 packed", "uint8+float32+uint16 packed", "int16+uint32+float32 lsd",
          "float16+int8 lsd", "+-0.0 float32+int8 packed"]


@pytest.mark.parametrize("want", ["values", "order", "kv"])
@pytest.mark.parametrize("multikey", ["auto", "lsd"])
@pytest.mark.parametrize("kind", TUPLES)
def test_multikey_sort_matches_repro(kind, multikey, want):
    keys, orders = _tuple(kind, 1001)
    values = RNG.integers(0, 1 << 20, 1001).astype(np.int32) if want == "kv" else None
    r, t = sort_both_raising(keys, values, order=orders,
                             want="order" if want == "order" else "values",
                             config=CFG, limits=_lim(multikey=multikey))
    assert_multikey_equal(r, t)
    assert t.meta.multikey == ("lsd" if multikey == "lsd" or "lsd" in kind else "packed")


@pytest.mark.parametrize("want", ["values", "order", "kv"])
@pytest.mark.parametrize("kind", ["int8+int16 packed", "float16+int8 lsd"])
def test_multikey_sort_matches_repro_pallas(kind, want):
    """With the kernels' twins (use_pallas=True, Pallas in interpret mode in
    repro): a packed sort runs the keys-only or the kv row sort, every LSD
    pass the kv one, over int32 provenance values and heavy ties."""
    keys, orders = _tuple(kind, 600)
    values = RNG.integers(0, 1 << 20, 600).astype(np.float32) if want == "kv" else None
    r, t = sort_both_raising(keys, values, order=orders,
                             want="order" if want == "order" else "values",
                             config=repro.SortConfig(tile=128), limits=_lim())
    assert_multikey_equal(r, t)


def test_packed_equals_lsd_equals_lexsort_without_negative_zero():
    keys, orders = _tuple("uint8+float32+uint16 packed", 3000)
    values = RNG.integers(0, 1 << 20, 3000).astype(np.int32)
    desc = [o == "desc" for o in orders]
    expect = np.lexsort(tuple(jkeyenc.flip_np(k) if d else k
                              for k, d in zip(keys[::-1], desc[::-1])))
    outs = [repro_torch.sort(keys, values, order=orders, device="cpu",
                             limits=repro_torch.SortLimits(multikey=mk))
            for mk in ("packed", "lsd")]
    for out in outs:
        for a, k in zip(out.keys, keys):
            assert_bits_equal(k[expect], port_np(a))
        np.testing.assert_array_equal(port_np(out.values), values[expect])


# ------------------------------------------------------------ the recipe


def _recipe_case(name: str):
    rng = np.random.default_rng(5)
    n = 300
    return {
        "narrow ints, negative": ([rng.integers(-100, 100, n).astype(np.int16),
                                   rng.integers(-8, 8, n).astype(np.int8)], None),
        "uint32 wide": ([rng.integers(0, 1 << 20, n).astype(np.uint32)] * 2, None),
        "float crossing zero": ([rng.normal(size=n).astype(np.float32),
                                 rng.integers(0, 4, n).astype(np.int8)], None),
        "float one side, narrow": ([np.float32(1.0) + rng.integers(0, 64, n).astype(np.float32)
                                    / 128, rng.integers(0, 4, n).astype(np.uint8)], None),
        "float16 not packable": ([rng.integers(0, 4, n).astype(np.int8),
                                  make_keys(rng, n, "float16", distinct=5)], None),
        "NaN column": ([np.array([1.0, np.nan, 2.0], np.float32), np.arange(3, dtype=np.int8)],
                       None),
        "declared": ([rng.integers(0, 16, n).astype(np.int16), rng.integers(0, 99, n).astype(np.uint8)],
                     (4, None)),
        "declared full int32": ([np.arange(n, dtype=np.int32)] * 2, (32, None)),
        "constant and empty": ([np.zeros(0, np.int8), np.zeros(0, np.float32)], None),
        "saturated 16+15": ([np.array([65535, 3], np.uint16), np.array([32767, 0], np.uint16)],
                            (16, 15)),
    }[name]


@pytest.mark.parametrize("descending", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("name", ["narrow ints, negative", "uint32 wide", "float crossing zero",
                                  "float one side, narrow", "float16 not packable", "NaN column",
                                  "declared", "declared full int32", "constant and empty",
                                  "saturated 16+15"])
def test_pack_recipe_matches_repro(name, descending):
    """plan_pack's spec and reason (the x64 hint names repro's own opt-in:
    kept word for word), pack_keys' int32 key, and both unpacks."""
    cols, key_bits = _recipe_case(name)
    want_spec, want_why = jkeyenc.plan_pack(cols, descending, key_bits, budget=31)
    ranks = {}
    spec, why = keyenc.plan_pack([tt(c) for c in cols], descending, key_bits, ranks=ranks)
    assert why == want_why
    if want_spec is None:
        assert spec is None
        return
    assert [vars(f) for f in spec.fields] == [vars(f) for f in want_spec.fields]
    packed = keyenc.pack_keys([tt(c) for c in cols], spec, ranks=ranks)
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(port_np(packed), jkeyenc.pack_keys(cols, want_spec))
    for c, got, host in zip(cols, keyenc.unpack_fields(packed, spec),
                            keyenc.unpack_np(port_np(packed), spec)):
        assert_bits_equal(c, port_np(got))
        assert host.dtype == c.dtype
        assert_bits_equal(c, host)


@pytest.mark.parametrize("key_bits,cols", [
    ((8, 8), (np.array([300, 1, 2], np.int16), np.array([1, 2, 3], np.int16))),
    ((8, 8), (np.array([1, 2, 3], np.int16), np.array([-1, 2, 3], np.int16))),
    ((4, None), (np.array([3, 1, 2], np.uint32), np.array([1, 2, 3], np.uint8))),
    ((4, 8, 1), (np.arange(3, dtype=np.int8),) * 2),
    ((4, 8), (np.arange(3, dtype=np.int16), np.array([1.0, 1.25, 1.5], np.float32))),
    ((4, 40), (np.arange(3, dtype=np.int16),) * 2),
    ([4, 4], (np.arange(3, dtype=np.int16),) * 2),
])
def test_key_bits_declared_and_violated(key_bits, cols):
    """Declared widths that hold sort as repro sorts; a violation, a bad
    shape or a float declaration raises repro's text."""
    for want in ("values", "order"):
        r, t = sort_both_raising(cols, want=want, config=CFG, limits=_lim(key_bits=key_bits))
        assert_multikey_equal(r, t)


def _saturating_pair(n=64):
    """16 + 15 = 31 bits; row 0 saturates every field: packed int32 max."""
    rng = np.random.default_rng(8)
    k1 = rng.integers(0, 1 << 16, n).astype(np.uint16)
    k2 = rng.integers(0, 1 << 15, n).astype(np.uint16)
    k1[0], k2[0] = (1 << 16) - 1, (1 << 15) - 1
    return k1, k2


@pytest.mark.parametrize("payload", ["keys only", "order", "values"])
def test_packed_sentinel(payload):
    """A saturated full pack: payload sorts raise repro's text (naming the
    packed value and its source columns); keys-only sorts run."""
    keys = _saturating_pair()
    kw = {"order": dict(want="order"), "keys only": {},
          "values": dict(values=np.arange(64, dtype=np.int32))}[payload]
    r, t = sort_both_raising(keys, config=CFG, limits=_lim(key_bits=(16, 15)), **kw)
    if payload != "keys only":
        assert isinstance(t, ValueError) and "2147483647" in str(t)
    assert_multikey_equal(r, t)


@pytest.mark.parametrize("case", ["empty tuple", "1-tuple", "1-tuple desc order", "n=0",
                                  "orders", "lengths", "NaN column keys only",
                                  "NaN column order", "forced packed", "bad multikey",
                                  "64-bit column", "sentinel column lsd", "2-D columns"])
def test_tuple_edges_match_repro(case):
    k = np.random.default_rng(7).integers(0, 9, 257).astype(np.int32)
    nan = (np.array([1.0, np.nan, 2.0], np.float32), np.array([1, 2, 3], np.int8))
    wide = tuple(np.random.default_rng(2).integers(0, 1 << 20, 100).astype(np.uint32)
                 for _ in range(2))
    keys, kw = {
        "empty tuple": ((), {}),
        "1-tuple": ((k,), dict(want="order")),
        "1-tuple desc order": ((k,), dict(order=("desc",))),
        "n=0": ((np.empty(0, np.int16), np.empty(0, np.float32)), dict(want="order")),
        "orders": ((k, k), dict(order=("asc", "desc", "asc"))),
        "lengths": ((k, k[:-1]), {}),
        "NaN column keys only": (nan, {}),
        "NaN column order": (nan, dict(want="order")),
        "forced packed": (wide, dict(limits=_lim(multikey="packed"))),
        "bad multikey": (wide, dict(limits=_lim(multikey="never"))),
        "64-bit column": ((k, k.astype(np.int64)), {}),
        "sentinel column lsd": ((k, np.array([2**31 - 1] * 257, np.int32)),
                                dict(want="order", limits=_lim(multikey="lsd"))),
        "2-D columns": ((k.reshape(1, -1), k[::-1].reshape(1, -1)), {}),
    }[case]
    kw.setdefault("limits", _lim())
    r, t = sort_both_raising(keys, config=CFG, **kw)
    if case.startswith("1-tuple"):
        assert t.meta.multikey is None and r.meta.multikey is None
        assert_bits_equal(r.keys, port_np(t.keys))
        np.testing.assert_array_equal(r.values if r.values is not None else [],
                                      port_np(t.values) if t.values is not None else [])
        return
    if case == "64-bit column":  # x64 mode is off: both refuse it, naming the opt-in
        assert type(r) is type(t) is TypeError
        assert "REPRO_X64=1" in str(t) and "REPRO_X64=1" in str(r)
        return
    assert_multikey_equal(r, t)
    if case == "n=0":
        assert t.keys[0].dtype == torch.int16 and t.keys[1].dtype == torch.float32
        assert t.meta.plan.packspec.total_bits == 0


@pytest.mark.parametrize("kind", TUPLES)
def test_plan_and_explain_match_repro(kind):
    """The decision, its reason words, the recipe and explain()'s multikey
    line (the x64 hint in a width reason names repro's opt-in, kept word
    for word)."""
    keys, orders = _tuple(kind, 500)
    want = repro.plan(keys, order=orders, want="order", limits=_lim(decode="host"))
    got = repro_torch.plan(keys, order=orders, want="order", device="cpu",
                           limits=port_limits(_lim(decode="host")))
    assert got.reasons == want.reasons
    assert (got.multikey, got.key_width, got.decode) == (want.multikey, want.key_width, want.decode)
    assert (got.packspec is None) == (want.packspec is None)
    if got.packspec is not None:
        assert got.packspec.describe() == want.packspec.describe()
    line = [x for x in want.explain().splitlines() if x.startswith("  multikey=")]
    assert line and line[0] in got.explain().splitlines()


# ---------------------------------------------------------------- fuzzer


def _fuzz_limits(multikey: str, decode: str):
    return repro.SortLimits(chunk_elems=1 << 12, n_procs=4, stream_threshold=None,
                            multikey=multikey, decode=decode)


@pytest.mark.parametrize("seed", range(60))
def test_fuzz_packed_lsd_lexsort_repro(seed):
    """fuzz_harness's cases on the sim backend, decode alternating between
    "device" and "host" by seed: port auto equals repro auto (outputs or
    the saturated-pack error), and port auto (when it packs), port LSD
    and np.lexsort agree."""
    case = fuzz_harness.make_case(seed)
    decode = "device" if seed % 2 == 0 else "host"
    kw = dict(order=case["orders"], want="order" if case["want"] == "order" else "values",
              config=fuzz_harness.CFG)
    r, t = sort_both_raising(case["keys"], case["values"], limits=_fuzz_limits("auto", decode),
                             **kw)
    assert_multikey_equal(r, t)
    perm = fuzz_harness.oracle_perm(case)
    lsd = repro_torch.sort(case["keys"], case["values"], device="cpu",
                           limits=port_limits(_fuzz_limits("lsd", decode)),
                           **dict(kw, config=repro_torch.SortConfig(use_pallas=False,
                                                                    capacity_factor=2.0)))
    outs = [lsd] if isinstance(t, Exception) else [t, lsd]
    for out in outs:
        for a, k in zip(out.keys, case["keys"]):
            np.testing.assert_array_equal(port_np(a), k[perm])
        if case["want"] == "order":
            np.testing.assert_array_equal(port_np(out.order()), perm)
        elif case["want"] == "kv":
            np.testing.assert_array_equal(port_np(out.values), case["values"][perm])
    if decode == "host":
        assert all(a.device.type == "cpu" for a in lsd.keys)
