"""``repro_torch``'s out-of-core stream backend against ``repro``'s.

Every case sends the same numpy input, made from a seed, through
``repro.sort(..., where="stream")`` and ``repro_torch.sort(...,
device="cpu")`` (or the two ``stream`` packages' own functions) and
compares keys, values / order, chunks, counts and the per-chunk ladder
accounting bit for bit. Sizes are small: n = 6000 keys (not a multiple of
the chunk) in chunks of 2^10 on 4 virtual processors, so every case runs
all three passes with several runs and buckets.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro
import repro.stream as rstream
import repro_torch
import repro_torch.stream as tstream
from repro.core import planner as rplanner
from repro_torch.core import planner as tplanner
from torch_parity import (DTYPES, assert_bits_equal, make_keys, port_config, port_limits,
                          port_np)

N = 6000
LIMITS = repro.SortLimits(n_procs=4, chunk_elems=1 << 10)
CFG = repro.SortConfig(use_pallas=False, tile=256)
PALLAS = repro.SortConfig(use_pallas=True, tile=256)
RNG = np.random.default_rng(18)


def stream_both(keys, values=None, *, config=CFG, limits=LIMITS, **kw):
    r = repro.sort(keys, values, where="stream", config=config, limits=limits, **kw)
    t = repro_torch.sort(keys, values, where="stream", config=port_config(config),
                         limits=port_limits(limits), device="cpu", **kw)
    return r, t


def assert_stream_equal(r, t) -> None:
    """Keys (each column of a tuple, dtype and bits), values, counts, n and
    the ladder accounting; the port's output lives on the host."""
    rk, tk = r.keys, t.keys
    for a, b in zip(rk, tk) if isinstance(rk, tuple) else [(rk, tk)]:
        assert b.device.type == "cpu"
        assert_bits_equal(a, port_np(b))
    if r.values is None:
        assert t.values is None
    else:
        assert_bits_equal(r.values, port_np(t.values))
    if r.counts is None:
        assert t.counts is None
    else:
        np.testing.assert_array_equal(r.counts, t.counts)
    assert t.meta.backend == r.meta.backend == "stream"
    assert (t.meta.n, t.meta.retries, t.meta.chunk_retries) == (
        r.meta.n, r.meta.retries, r.meta.chunk_retries)


@pytest.mark.parametrize("order", ["asc", "desc"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_keys_only_matches_repro(dtype, order):
    keys = make_keys(RNG, N, dtype)
    if dtype == "bfloat16" and order == "desc":
        # repro's stream cannot flip bfloat16 on numpy (its flip_np's `~`
        # on an ml_dtypes array, ROADMAP §3): the port is held to repro's
        # stream of the same keys as float32 (exact), cast back
        with pytest.raises(TypeError):
            repro.sort(keys, where="stream", config=CFG, limits=LIMITS, order=order).keys
        want = repro.sort(keys.astype(np.float32), where="stream", config=CFG, limits=LIMITS,
                          order=order)
        t = repro_torch.sort(keys, where="stream", config=port_config(CFG),
                             limits=port_limits(LIMITS), device="cpu", order=order)
        assert_bits_equal(want.keys.astype(keys.dtype), port_np(t.keys))
        return
    assert_stream_equal(*stream_both(keys, order=order))


@pytest.mark.parametrize("dtype,kw", [
    ("float32", dict(order="asc")),
    ("int16", dict(want="order", order="desc")),
    ("uint32", dict(values="float32", order="desc")),
])
def test_pallas_paths_match_repro(dtype, kw):
    """The bitonic kernels' twins on every pass (repro in Pallas interpret
    mode): chunk tile sorts, merge rounds, bucket merge trees, and the kv
    tie rule that breaks on the value (n = 3000 to bound the interpreter's
    time)."""
    kw = dict(kw)
    keys = make_keys(RNG, N // 2, dtype, distinct=40 if "want" in kw else None)
    values = make_keys(RNG, N // 2, kw.pop("values")) if "values" in kw else None
    assert_stream_equal(*stream_both(keys, values, config=PALLAS, **kw))


@pytest.mark.parametrize("kdtype,kw", [
    ("float32", dict(want="order")),
    ("int8", dict(want="order", order="desc")),
    ("uint16", dict(want="order")),
    ("float32", dict(values="int32")),
    ("int32", dict(values="uint16", order="desc")),
    ("bfloat16", dict(values="float32")),
])
def test_order_and_payload_match_repro(kdtype, kw):
    """Few distinct keys, so equal-key runs cross chunk and bucket
    boundaries: the device tie fix per bucket and the host stitch
    (planner._stitch_bucket_ties) give repro's stable permutation."""
    kw = dict(kw)
    keys = make_keys(RNG, N, kdtype, distinct=6)
    values = make_keys(RNG, N, kw.pop("values")) if "values" in kw else None
    r, t = stream_both(keys, values, **kw)
    assert_stream_equal(r, t)
    if kw.get("want") == "order":
        assert torch.equal(t.order(), t.values)


@pytest.mark.parametrize("dtype,kw", [("float32", dict(order="desc")),
                                      ("uint32", dict(order="desc")),
                                      ("float32", dict(want="order", order="desc")),
                                      ("float32", dict(want="order")),
                                      ("uint16", dict(values="int32", order="desc"))])
def test_host_decode_matches_repro(dtype, kw):
    """decode="host": the legacy reverse of a keys-only result, the host
    flip of a kv one, and the whole-array host tie fix."""
    kw = dict(kw)
    keys = make_keys(RNG, N, dtype, distinct=9) + (1 if dtype.startswith("u") else 0)
    values = make_keys(RNG, N, kw.pop("values")) if "values" in kw else None
    limits = dataclasses.replace(LIMITS, decode="host")
    assert_stream_equal(*stream_both(keys, values, limits=limits, **kw))


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_flip_flips_the_sign_bit(dtype):
    """keyenc.flip flips the sign bit and nothing else, so it is -x on the
    CPU (and in repro) for every float32 and float16 key, NaN included: a
    descending stream flips NaN keys on the card, whose -x returns other
    NaN bits. (The CPU's bfloat16 -x goes through float32 and returns its
    NaN with other bits too: there flip keeps the payload.)"""
    from repro_torch.core import keyenc

    x = np.array([1.5, -2.0, 0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan], np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    bits = port_np(t).view(f"i{t.element_size()}")
    sign = np.array(1 << (8 * t.element_size() - 1)).astype(bits.dtype)
    np.testing.assert_array_equal(port_np(keyenc.flip(t)).view(bits.dtype), bits ^ sign)
    keep = slice(None) if dtype != "bfloat16" else slice(0, 6)
    assert_bits_equal(port_np(keyenc.flip(t))[keep], port_np(-t)[keep])


@pytest.mark.parametrize("nan", [False, True])
def test_select_splitters_orders_samples_as_repro(nan):
    """select_splitters equals repro's: on keys with -0.0 and +0.0 (and,
    with ``nan``, NaN of either sign), through the total-order sort that a
    sort holding NaN takes (``nan_keys=True``), and without NaN through
    the plain sort too, which every NaN-free sort keeps."""
    import jax.numpy as jnp
    from repro.core import splitters as rspl
    from repro_torch.core import splitters as tspl

    x = np.random.default_rng(4).normal(0, 1, 4096).astype(np.float32)
    x[::7], x[3::7] = 0.0, -0.0
    if nan:
        x[5::11], x[6::13] = np.nan, -np.nan
    want = np.asarray(rspl.select_splitters(jnp.asarray(x), 64))
    t = torch.from_numpy(x)
    assert_bits_equal(want, port_np(tspl.select_splitters(t, 64, nan_keys=True)))
    if not nan:
        assert_bits_equal(want, port_np(tspl.select_splitters(t, 64)))


def test_stitch_bucket_ties_matches_repro():
    rng = np.random.default_rng(0)
    ks = np.sort(rng.integers(0, 5, 400)).astype(np.float32)
    vs = rng.permutation(400).astype(np.int32)
    sizes = [90, 110, 100, 100]
    for desc in (False, True):
        k = ks[::-1].copy() if desc else ks
        want = rplanner._stitch_bucket_ties(k, vs, sizes, descending=desc)
        got = tplanner._stitch_bucket_ties(k, vs, sizes, descending=desc)
        np.testing.assert_array_equal(want, got)


def test_iterator_input_matches_repro_and_the_array():
    """Ragged pieces are re-chunked; the result equals repro's, and the
    same keys given as one array."""
    pieces = [make_keys(RNG, int(m), "float32") for m in RNG.integers(1, 900, 12)]
    r = repro.sort(iter(pieces), config=CFG, limits=LIMITS)
    t = repro_torch.sort(iter(pieces), config=port_config(CFG), limits=port_limits(LIMITS),
                         device="cpu")
    assert_stream_equal(r, t)
    assert t.meta.plan.reasons[0] == r.meta.plan.reasons[0]
    whole = repro_torch.sort(np.concatenate(pieces), where="stream", config=port_config(CFG),
                             limits=port_limits(LIMITS), device="cpu")
    assert torch.equal(whole.keys, t.keys)
    # a list of arrays is an iterator too; its chunks() stream
    r, t = stream_both(list(pieces), order="desc")
    for a, b in zip(r.chunks(), t.chunks(), strict=True):
        assert_bits_equal(a, port_np(b))
    np.testing.assert_array_equal(r.counts, t.counts)


def test_chunks_are_single_use_as_in_repro():
    keys = make_keys(RNG, N, "int32")
    r, t = stream_both(keys)
    assert [c.shape[0] for c in r.chunks()] == [c.shape[0] for c in t.chunks()]
    for out in (r, t):
        with pytest.raises(ValueError, match="already consumed via chunks"):
            out.keys
    r, t = stream_both(keys, want="order")
    for out in (r, t):
        with pytest.raises(ValueError, match="does not stream") as e:
            out.chunks().__next__()
    assert str(e.value).startswith("this stream result does not stream")


@pytest.mark.parametrize("kw", [dict(), dict(want="order"), dict(order="desc")])
def test_empty_dataset(kw):
    """An empty array or iterator is an empty result, dtype kept."""
    keys = np.zeros(0, np.int16)
    r, t = stream_both(keys, **kw)
    assert t.keys.dtype == torch.int16 and t.keys.shape == (0,)
    assert_stream_equal(r, t)
    assert list(t.chunks()) == []
    r, t = stream_both(iter([]), order=kw.get("order", "asc"))
    assert t.keys.dtype == torch.float32 and t.keys.shape == (0,)
    assert_bits_equal(r.keys, port_np(t.keys))
    assert list(tstream.sort_stream(np.zeros(0, np.float32), device="cpu")) == []
    part = tstream.partition_runs([], device="cpu")
    assert part.n_buckets == 0 and part.load_imbalance() == 1.0


def test_mismatched_values_and_iterator_payloads_refused_as_repro():
    k = np.arange(2048, dtype=np.int32)
    rcfg = rstream.StreamConfig(chunk_elems=512, n_procs=4, sort=CFG)
    tcfg = tstream.StreamConfig(chunk_elems=512, n_procs=4, sort=port_config(CFG))
    for v in (np.arange(1024, dtype=np.int32), np.arange(3072, dtype=np.int32)):
        with pytest.raises(ValueError) as want:
            rstream.sort_external_kv(k, v, rcfg)
        with pytest.raises(ValueError, match="chunk identically") as got:
            tstream.sort_external_kv(k, v, tcfg, device="cpu")
        assert str(got.value) == str(want.value)
    for kw in (dict(want="order"), dict(values=k)):
        with pytest.raises(ValueError) as want:
            repro.sort(iter([k]), config=CFG, **kw)
        with pytest.raises(ValueError) as got:
            repro_torch.sort(iter([k]), device="cpu", **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("want", ["values", "order"])
def test_chunk_ladder_retries_and_counts_match_repro(want):
    """Tight buckets: chunks overflow and walk the ladder; the sum and the
    per-chunk breakdown equal repro's, and so do the output counts."""
    keys = make_keys(RNG, N, "int32", distinct=3)
    cfg = dataclasses.replace(CFG, capacity_factor=0.3)
    r, t = stream_both(keys, config=cfg, want=want)
    assert_stream_equal(r, t)
    assert t.meta.retries > 0 and any(t.meta.chunk_retries)


def _dup90(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.where(rng.random(8 << 12) < 0.9, np.float32(3.0),
                    rng.normal(0, 1, 8 << 12)).astype(np.float32)


def test_partition_balanced_under_90pct_duplicates_as_repro():
    """Table II across passes: the bucket sizes equal repro's, their
    imbalance is at most 1.05, and without the investigator the duplicated
    key floods one bucket (more than 2x worse), as tests/test_stream.py
    checks for repro."""
    x = _dup90(6)
    rcfg = rstream.StreamConfig(chunk_elems=1 << 12, n_procs=4, sort=CFG)
    tcfg = tstream.StreamConfig(chunk_elems=1 << 12, n_procs=4, sort=port_config(CFG))
    rruns = rstream.generate_runs(x, rcfg)
    truns = tstream.generate_runs(x, tcfg, device="cpu")
    for a, b in zip(rruns, truns, strict=True):
        assert_bits_equal(a.keys, port_np(b.keys))
    for inv in (True, False):
        rp = rstream.partition_runs(rruns, rcfg, investigator=inv)
        tp = tstream.partition_runs(truns, tcfg, investigator=inv, device="cpu")
        np.testing.assert_array_equal(rp.bucket_sizes, tp.bucket_sizes)
        assert_bits_equal(rp.splitters, port_np(tp.splitters))
        for rs, ts in zip(rp.segments, tp.segments, strict=True):
            assert [len(s) for s in rs] == [len(s) for s in ts]
    # each bucket's segments through merge_segments[_kv], both packages
    for rs, ts in list(zip(rp.segments, tp.segments))[:2]:
        assert_bits_equal(rstream.merge_segments(rs, use_pallas=False),
                          port_np(tstream.merge_segments(ts, use_pallas=False, device="cpu")))
        rv = [np.arange(len(x), dtype=np.int32) for x in rs]
        tv = [torch.arange(len(x), dtype=torch.int32) for x in ts]
        for want, got in zip(rstream.merge_segments_kv(rs, rv, use_pallas=False,
                                                       segment_stable=True),
                             tstream.merge_segments_kv(ts, tv, use_pallas=False,
                                                       segment_stable=True, device="cpu")):
            assert_bits_equal(want, port_np(got))
    balanced = tstream.partition_runs(truns, tcfg, device="cpu")
    naive = tstream.partition_runs(truns, tcfg, investigator=False, device="cpu")
    assert balanced.n_buckets >= 8 and balanced.load_imbalance() <= 1.05
    assert naive.load_imbalance() > 2.0 * balanced.load_imbalance()
    got = tstream.sort_external(x, tcfg, device="cpu")
    assert_bits_equal(rstream.sort_external(x, rcfg), port_np(got))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_of_four_values_at_the_smoke_shape_matches_repro(seed):
    """chip_smoke.py phase 6's Table II case on the host: 2^23 int32 keys
    in [0, 4), in runs of 2^16 at the default StreamConfig (128 runs, 128
    buckets). The port's bucket sizes and splitters equal repro's, with
    and without the investigator, and the naive partition is more than 2x
    worse. repro's own imbalance there is above the 1.05 that
    tests/test_stream.py holds at 8 buckets (each value spans about 32
    buckets, and the bucket at a value's edge takes the excess), so the
    card is held to this partition and not to 1.05. A keys-only run is its
    chunk sorted (the 90%-duplicates test above checks generate_runs)."""
    x = np.random.default_rng(seed).integers(0, 4, 1 << 23).astype(np.int32)
    chunks = np.sort(x.reshape(128, 1 << 16), axis=1)
    rruns = [rstream.Run(c) for c in chunks]
    truns = [tstream.Run(torch.from_numpy(c)) for c in chunks]
    parts = {}
    for inv in (True, False):
        rp = rstream.partition_runs(rruns, rstream.StreamConfig(), investigator=inv)
        tp = tstream.partition_runs(truns, tstream.StreamConfig(), investigator=inv,
                                    device="cpu")
        assert tp.n_buckets == rp.n_buckets == 128
        np.testing.assert_array_equal(rp.bucket_sizes, tp.bucket_sizes)
        assert_bits_equal(rp.splitters, port_np(tp.splitters))
        assert tp.load_imbalance() == rp.load_imbalance()
        parts[inv] = tp.load_imbalance()
    print(f"seed {seed}: imbalance {parts[True]!r}, naive {parts[False]!r}")
    assert 1.05 < parts[True] < 1.2
    assert parts[False] > 2.0 * parts[True]


@pytest.mark.parametrize("case", ["packed", "packed-order", "packed-values", "lsd-values",
                                  "packed-host"])
def test_tuples_stream_as_repro(case):
    """A packed tuple streams through one int32 stream sort (keys-only:
    chunks() yields column tuples, unpacked per chunk); an LSD tuple runs
    kv stream passes through the same planner code."""
    ids = RNG.integers(0, 40, N).astype(np.int32)
    times = RNG.integers(0, 1 << 10, N).astype(np.int32)
    f = make_keys(RNG, N, "float32")
    kw = dict(order=("asc", "desc"))
    if case == "packed-order":
        kw["want"] = "order"
    if case == "packed-values":
        kw["values"] = make_keys(RNG, N, "float32")
    if case == "lsd-values":
        kw.update(values=make_keys(RNG, N, "int16"), limits=dataclasses.replace(
            LIMITS, multikey="lsd"))
    if case == "packed-host":
        kw["limits"] = dataclasses.replace(LIMITS, decode="host")
    keys = (f, ids) if case == "lsd-values" else (ids, times)
    r, t = stream_both(keys, **kw)
    assert t.meta.multikey == r.meta.multikey == ("lsd" if case == "lsd-values" else "packed")
    if case == "packed":
        for a, b in zip(r.chunks(), t.chunks(), strict=True):
            for ca, cb in zip(a, b, strict=True):
                assert_bits_equal(ca, port_np(cb))
        np.testing.assert_array_equal(r.counts, t.counts)
        r, t = stream_both(keys, **kw)
    assert_stream_equal(r, t)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("order", ["asc", "desc"])
def test_nan_keys_stream_as_repro(order, use_pallas):
    """Keys-only float keys with 5% NaN: every pass (the chunk sorts, the
    boundary search, the bucket merges) follows repro's probes, so the
    port keeps exactly the keys repro keeps. Payload streams refuse NaN."""
    rng = np.random.default_rng(5)
    keys = rng.integers(-50, 50, N).astype(np.float32)
    keys[rng.random(N) < 0.05] = np.nan
    config = PALLAS if use_pallas else CFG
    if use_pallas:
        keys = keys[:N // 2]
    assert_stream_equal(*stream_both(keys, config=config, order=order))
    if not use_pallas:
        with pytest.raises(ValueError) as want:
            repro.sort(keys, where="stream", config=CFG, limits=LIMITS, want="order").keys
        with pytest.raises(ValueError) as got:
            repro_torch.sort(keys, where="stream", config=port_config(CFG),
                             limits=port_limits(LIMITS), want="order", device="cpu")
        assert str(got.value) == str(want.value)


def test_above_threshold_streams_by_default_and_input_stays_put():
    """Past stream_threshold the planner streams, with repro's reasons; the
    caller's array is read where it lies and left unchanged."""
    keys = make_keys(RNG, N, "uint32")
    before = keys.copy()
    limits = dataclasses.replace(LIMITS, stream_threshold=N - 1)
    r, t = (repro.sort(keys, config=CFG, limits=limits),
            repro_torch.sort(keys, config=port_config(CFG), limits=port_limits(limits),
                             device="cpu"))
    assert t.meta.plan.reasons == r.meta.plan.reasons
    assert_stream_equal(r, t)
    np.testing.assert_array_equal(keys, before)
    plan = repro_torch.plan(iter([keys]), device="cpu")
    assert plan.backend == "stream" and plan.key_width == 32
    with pytest.raises(ValueError, match="iterator inputs can only run on the stream"):
        repro_torch.sort(iter([keys]), where="sim", device="cpu")


def test_stream_functions_match_repro():
    """sort_external / sort_stream / sort_external_kv of both packages on a
    90%-duplicate input, with an output chunk size of their own."""
    x = _dup90(7)[:N]
    rcfg = rstream.StreamConfig(chunk_elems=1 << 10, n_procs=4, sort=CFG, out_chunk_elems=300)
    tcfg = tstream.StreamConfig(chunk_elems=1 << 10, n_procs=4, sort=port_config(CFG),
                                out_chunk_elems=300)
    chunks = list(tstream.sort_stream(x, tcfg, descending=True, device="cpu"))
    assert all(c.shape[0] <= 300 for c in chunks)
    for a, b in zip(rstream.sort_stream(x, rcfg, descending=True), chunks, strict=True):
        assert_bits_equal(a, port_np(b))
    v = np.arange(N, dtype=np.int32)
    rs, ts = {}, {}
    rk, rv = rstream.sort_external_kv(x, v, rcfg, stats=rs, segment_stable=True)
    tk, tv = tstream.sort_external_kv(x, v, tcfg, stats=ts, segment_stable=True, device="cpu")
    assert_bits_equal(rk, port_np(tk))
    assert_bits_equal(rv, port_np(tv))
    assert rs == ts


@pytest.mark.parametrize("block", [None, 1 << 11])
@pytest.mark.parametrize("kind", ["array", "iterator"])
def test_runs_lie_in_host_blocks_that_pass_3_gathers_from(kind, block, monkeypatch):
    """Pass 1 writes the runs into a few host blocks (one for an array up
    to the block size; for an iterator, blocks of one chunk, then twice the
    last), the partition keeps those blocks without a copy, and pass 3's
    gathers across block edges give repro's keys and values. ``block``:
    a small block size, so an array's runs span several blocks too."""
    from repro_torch.stream import runs as truns_mod

    if block is not None:
        monkeypatch.setattr(truns_mod, "_BLOCK_ELEMS", block)
    x = _dup90(8)[:N]
    v = np.arange(N, dtype=np.int32)
    rcfg = rstream.StreamConfig(chunk_elems=1 << 10, n_procs=4, sort=CFG)
    tcfg = tstream.StreamConfig(chunk_elems=1 << 10, n_procs=4, sort=port_config(CFG))

    def data():
        return x if kind == "array" else iter(np.array_split(x, 7))

    runs = tstream.generate_runs(data(), tcfg, device="cpu")
    part = tstream.partition_runs(runs, tcfg, device="cpu")
    homes = list({id(r.home[0]): r.home[0] for r in runs}.values())
    assert [b.data_ptr() for b in part.blocks] == [b.data_ptr() for b in homes]
    sizes = [b.shape[0] for b in part.blocks]
    want_sizes = {("array", None): [N], ("array", 1 << 11): [2048, 2048, N - 4096],
                  ("iterator", None): [1024, 2048, 4096],
                  ("iterator", 1 << 11): [1024, 2048, 2048, 2048]}[kind, block]
    assert sizes == want_sizes
    for r in runs:
        kb, _, off = r.home
        assert r.keys.data_ptr() == kb[off:].data_ptr()
    assert_bits_equal(rstream.sort_external(x, rcfg),
                      port_np(tstream.sort_external(data(), tcfg, device="cpu")))
    vals = v if kind == "array" else iter(np.array_split(v, 7))
    for want, got in zip(rstream.sort_external_kv(x, v, rcfg, segment_stable=True),
                         tstream.sort_external_kv(data(), vals, tcfg, segment_stable=True,
                                                  device="cpu"), strict=True):
        assert_bits_equal(want, port_np(got))
