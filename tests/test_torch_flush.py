"""The batched flush (``repro_torch.stream.service``) against ``repro``'s
vmapped one: ``FlushEngine.run_group``, ``SortService`` (``sort_many``,
``flush``, ``SortServiceError``) and ``SortLibrary.sort_many`` on the same
numpy inputs, bit for bit, with the same ladder steps and ``stats``
(programs, hits, batches, retries) and the same flight records. Buckets:
ascending, descending and packed; a batch with NaN and +-0.0 in one
member; a batch where one member overflows. Each member also equals the
port's unbatched ``sample_sort_sim_flat`` of its own grid.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import keyenc as rkeyenc
from repro.core import planner as rplanner
from repro.obs import flight as rflight
from repro.stream import service as rservice
from repro_torch.core import keyenc as tkeyenc
from repro_torch.core import planner as tplanner
from repro_torch.core import sim as tsim
from repro_torch.obs import flight as tflight
from repro_torch.stream import service as tservice
from torch_parity import assert_bits_equal, make_keys, port_config, port_np, tt

CFG = repro.SortConfig(use_pallas=False)
SIZES = [700, 1000, 1024, 513, 900]  # one bucket of 1024, two flushes at max_batch 4


def _engines(config=CFG, **kw):
    kw.setdefault("n_procs", 4)
    kw.setdefault("max_batch", 4)
    r = rservice.FlushEngine(config=config, **kw)
    t = tservice.FlushEngine(config=port_config(config), device="cpu", **kw)
    return r, t


def _same(want, got) -> None:
    """One request's result: an array (or a tuple of columns) or the same
    terminal error, with the same ladder steps."""
    (w, ws), (g, gs) = want, got
    assert gs == ws
    if isinstance(w, Exception):
        assert type(g).__name__ == type(w).__name__ and str(g) == str(w)
        return
    if isinstance(w, tuple):
        assert isinstance(g, tuple) and len(g) == len(w)
        for a, b in zip(w, g):
            assert b.device.type == "cpu"
            assert_bits_equal(a, port_np(b))
        return
    assert g.device.type == "cpu"
    assert_bits_equal(w, port_np(g))


def _flushes(recorder, n):
    return [{k: f[k] for k in ("kind", "batch", "padded_batch", "elems", "dtype", "retries",
                               "overflowed")}
            for f in recorder.snapshot()["flushes"][-n:]]


def _run_both(r, t, datas, **kw):
    rflight.RECORDER.reset()
    tflight.RECORDER.reset()
    want = r.run_group(datas, **kw)
    got = t.run_group([tt(d) for d in datas], **kw)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        _same(a, b)
    n = len(rflight.RECORDER.snapshot()["flushes"])
    assert _flushes(tflight.RECORDER, n) == _flushes(rflight.RECORDER, n)
    assert t.stats == r.stats
    return got


@pytest.mark.parametrize("dtype,descending", [
    (d, desc) for d in ("float32", "int32", "uint32", "int16", "bfloat16", "uint8")
    for desc in (False, True) if not (desc and d == "bfloat16")])
def test_run_group_matches_repro(dtype, descending):
    rng = np.random.default_rng(len(dtype) + descending)
    datas = [make_keys(rng, n, dtype) for n in SIZES]
    r, t = _engines()
    got = _run_both(r, t, datas, descending=descending)
    # the same bucket again: the cache serves both flushes' programs
    _run_both(r, t, datas[:3], descending=descending)
    assert t.stats["hits"] >= 1

    # each member is the port's unbatched flat sort of its own grid
    cfg = port_config(CFG)
    for d, (res, _) in zip(datas, got):
        x = tkeyenc.to_lane(tt(d))
        fill = tservice.FlushEngine._fill(x.dtype, descending)
        grid = tplanner.pad_grid(x, 4, 256, fill)
        one = tsim.sample_sort_sim_flat(grid, cfg, descending=descending).flat[:len(d)]
        assert torch.equal(tkeyenc.from_lane(one, tt(d).dtype).view(torch.uint8),
                           res.view(torch.uint8))


def test_descending_bfloat16_equals_repros_float32_flush():
    """repro's flush cannot stage a flipped bfloat16 sentinel (its
    ``keyenc.flip_np`` applies ``~`` to an ml_dtypes array: TypeError), so
    the port's descending bfloat16 flush is held to repro's of the same
    keys as float32 (exact both ways)."""
    rng = np.random.default_rng(13)
    datas = [make_keys(rng, n, "bfloat16") for n in SIZES]
    r, t = _engines()
    want = r.run_group([d.astype(np.float32) for d in datas], descending=True)
    got = t.run_group([tt(d) for d in datas], descending=True)
    for (w, ws), (g, gs) in zip(want, got):
        assert gs == ws and g.dtype == torch.bfloat16
        assert_bits_equal(w.astype(datas[0].dtype), port_np(g))


def test_packed_bucket_matches_repro():
    """Packed (int32, int32) pairs with declared widths: the flush unpacks
    the columns on the device; each result is the column tuple."""
    rng = np.random.default_rng(11)
    limits = repro.SortLimits(n_procs=4, key_bits=(10, 12))
    cols = [(rng.integers(0, 1 << 10, n).astype(np.int32),
             rng.integers(0, 1 << 12, n).astype(np.int32)) for n in SIZES]
    rdata, tdata, specs = [], [], []
    for a, b in cols:
        req, plan, ok = rplanner.serve_profile((a, b), order=("asc", "desc"), limits=limits,
                                               config=CFG)
        treq, tplan, tok = tplanner.serve_profile(
            (a, b), order=("asc", "desc"), limits=tplanner.SortLimits(n_procs=4,
                                                                      key_bits=(10, 12)),
            config=port_config(CFG), device="cpu")
        assert ok and tok and plan.multikey == tplan.multikey == "packed"
        rdata.append(rkeyenc.pack_keys(req.keys, plan.packspec, ranks=req.pack_ranks))
        tdata.append(tkeyenc.pack_keys(treq.keys, tplan.packspec, ranks=treq.pack_ranks))
        specs.append((plan.packspec, tplan.packspec))
    for a, b in zip(rdata, tdata):
        assert_bits_equal(a, port_np(b))
    r, t = _engines()
    rflight.RECORDER.reset()
    tflight.RECORDER.reset()
    want = r.run_group(rdata, packspec=specs[0][0])
    got = t.run_group(tdata, packspec=specs[0][1])
    for a, b in zip(want, got):
        _same(a, b)
    assert t.stats == r.stats
    assert _flushes(tflight.RECORDER, 2) == _flushes(rflight.RECORDER, 2)
    for (a, b), (res, _) in zip(cols, got):
        order = np.lexsort((-b.astype(np.int64), a))
        np.testing.assert_array_equal(res[0].numpy(), a[order])
        np.testing.assert_array_equal(res[1].numpy(), b[order])


@pytest.mark.parametrize("descending", [False, True])
def test_a_nan_member_takes_the_batch_down_repros_search(descending):
    """One member holds NaN and +-0.0, the others neither: repro's vmapped
    flush searches every row with jax's probes; the port probes the batch
    once and gives every member repro's bits."""
    rng = np.random.default_rng(5)
    datas = [rng.integers(-20, 20, n).astype(np.float32) for n in SIZES[:4]]
    nan = datas[1]
    nan[nan == 0] = np.where(rng.random((nan == 0).sum()) < 0.5, 0.0, -0.0)
    nan[rng.random(nan.shape) < 0.05] = np.nan
    r, t = _engines()
    _run_both(r, t, datas, descending=descending)


def test_one_member_overflows_alone():
    """Without the investigator an all-equal member sends everything to
    one destination: it alone walks the ladder (the batched attempt was
    its first rung); the others resolve from the batch."""
    rng = np.random.default_rng(9)
    datas = [rng.standard_normal(n).astype(np.float32) for n in SIZES[:4]]
    datas[2] = np.full(SIZES[2], 3.0, np.float32)
    r, t = _engines(investigator=False)
    got = _run_both(r, t, datas)
    steps = [s for _, s in got]
    assert steps[2] >= 2 and steps[:2] == [0, 0]
    assert t.stats["retries"] == sum(steps)
    # a ladder too short: that member fails terminally, alone
    r, t = _engines(investigator=False, max_doublings=1)
    got = _run_both(r, t, datas)
    assert isinstance(got[2][0], repro_torch.SortOverflowError)
    assert all(not isinstance(res, Exception) for i, (res, _) in enumerate(got) if i != 2)


def _services(config=CFG, **kw):
    kw.setdefault("n_procs", 4)
    return (rservice.SortService(config=config, **kw),
            tservice.SortService(config=port_config(config), device="cpu", **kw))


def test_sort_service_matches_repro():
    rng = np.random.default_rng(3)
    arrays = ([make_keys(rng, n, "float32") for n in (100, 128, 77, 3000, 2049)]
              + [make_keys(rng, n, "int32") for n in (100, 128)]
              + [make_keys(rng, 50, "uint16")])
    r, t = _services(max_batch=2)
    want = r.sort_many(arrays)
    got = t.sort_many(arrays)
    for a, b in zip(want, got):
        assert_bits_equal(a, port_np(b))
        assert b.dtype == tt(a).dtype
    assert t.stats == r.stats
    # submit / flush by rid, and sort()
    rids = [t.submit(a) for a in arrays[:3]]
    done = t.flush()
    assert sorted(done) == rids
    assert_bits_equal(r.sort(arrays[0]), port_np(t.sort(arrays[0])))
    assert t._bucket_elems(100) == r._bucket_elems(100) == 128
    assert t.policy == tservice.FlushEngine(device="cpu").policy


def test_sort_service_error_keeps_the_survivors():
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal(1000).astype(np.float32), np.full(1000, 1.0, np.float32),
              rng.standard_normal(900).astype(np.float32)]
    r, t = _services(investigator=False, max_doublings=1)
    with pytest.raises(rservice.SortServiceError) as we:
        r.sort_many(arrays)
    with pytest.raises(tservice.SortServiceError) as ge:
        t.sort_many(arrays)
    assert str(ge.value) == str(we.value)
    assert sorted(ge.value.results) == sorted(we.value.results) == [0, 2]
    assert sorted(ge.value.errors) == [1]
    for rid in (0, 2):
        assert_bits_equal(we.value.results[rid], port_np(ge.value.results[rid]))
    assert t.stats == r.stats
    snap = tflight.RECORDER.snapshot()
    outcomes = [q["outcome"] for q in snap["requests"][-3:]]
    assert outcomes == ["completed", "failed", "completed"]


def test_service_flush_records_link_requests_to_flushes():
    tflight.RECORDER.reset()
    t = tservice.SortService(config=port_config(CFG), n_procs=4, device="cpu")
    rng = np.random.default_rng(6)
    t.sort_many([rng.standard_normal(n).astype(np.float32) for n in (300, 400, 500)])
    snap = tflight.RECORDER.snapshot()
    (flush,) = snap["flushes"]
    reqs = snap["requests"]
    assert flush["requests"] == [q["trace_id"] for q in reqs]
    assert {q["flush_id"] for q in reqs} == {flush["flush_id"]}
    assert all(q["coalesced"] == 3 and q["dtype"] == "float32" for q in reqs)
    assert flush["batch"] == 3 and flush["padded_batch"] == 4 and flush["dtype"] == "float32"
    assert set(flush["phases"]) == {"stage_ms", "sort_ms", "d2h_ms"}


def test_use_pallas_true_matches_repro_in_interpret_mode():
    cfg = repro.SortConfig(use_pallas=True, tile=64)
    rng = np.random.default_rng(8)
    datas = [make_keys(rng, n, "float32") for n in (200, 256, 130)]
    r, t = _engines(config=cfg)
    _run_both(r, t, datas)
    _run_both(r, t, datas, descending=True)


def test_sort_library_sort_many_matches_repro():
    rng = np.random.default_rng(10)
    arrays = [make_keys(rng, (4, 300), "float32"), make_keys(rng, (4, 300), "float32"),
              make_keys(rng, (4, 128), "int32"), make_keys(rng, (4, 300), "float32")]
    rlib = repro.SortLibrary(config=CFG)
    tlib = repro_torch.SortLibrary(config=port_config(CFG), device="cpu")
    with pytest.warns(DeprecationWarning):
        repro.core.api._reset_deprecation_registry()
        want = rlib.sort_many(arrays)
    with pytest.warns(DeprecationWarning, match="SortLibrary.sort_many is deprecated"):
        repro_torch.core.api._reset_deprecation_registry()
        got = tlib.sort_many(arrays)
    for w, g in zip(want, got):
        assert_bits_equal(w.values, port_np(g.values))
        np.testing.assert_array_equal(np.asarray(w.counts), g.counts.numpy())
        np.testing.assert_array_equal(np.asarray(w.send_counts), g.send_counts.numpy())
        assert bool(w.overflowed) == bool(g.overflowed)
    cache_r, cache_t = repro.core.api.sort_many_cache(), repro_torch.core.api.sort_many_cache()
    assert set(cache_t.stats) == {"programs", "hits"}
    assert len(cache_t.programs) >= 2 and cache_r.stats.keys() == cache_t.stats.keys()


def test_sort_library_facade_routes_through_sort():
    rng = np.random.default_rng(12)
    x = make_keys(rng, (4, 256), "int32")
    tlib = repro_torch.SortLibrary(config=port_config(CFG), device="cpu")
    rlib = repro.SortLibrary(config=CFG)
    with pytest.warns(DeprecationWarning):
        repro_torch.core.api._reset_deprecation_registry()
        got = tlib.sort(x)
    repro.core.api._reset_deprecation_registry()
    with pytest.warns(DeprecationWarning):
        want = rlib.sort(x)
    assert_bits_equal(np.asarray(want.values), port_np(got.values))
    with pytest.warns(DeprecationWarning):
        keys, cfg = tlib.sort_with_retry(x)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(port_config(CFG))
    flat = make_keys(rng, 5000, "float32")
    with pytest.warns(DeprecationWarning):
        ext = tlib.sort_external(flat, chunk_elems=1 << 11, n_procs=4)
    np.testing.assert_array_equal(port_np(ext), np.sort(flat))
    with pytest.raises(TypeError, match="DeviceMesh"), pytest.warns(DeprecationWarning):
        tlib.distributed_sort(x.reshape(-1), mesh=object())
