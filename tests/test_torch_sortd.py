"""``repro_torch.serve.sortd.SortServer(device="cpu")`` against
``repro.serve.sortd.SortServer`` on the same requests. Servers are paused
(a long ``max_delay_ms`` and a large ``max_batch``) and drained with one
``flush()``, so no case depends on timing: results bit for bit,
``meta.coalesced`` and ``meta.retries``, the weighted-fair dispatch order
of two tenants, admission errors, cancellation, close and drain, the
sort-adjacent views, ``stream_chunks`` and directly dispatched argsort
and key/value requests.
"""
import threading

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.serve import sortd as rsortd
from repro_torch.serve import sortd as tsortd
from torch_parity import assert_bits_equal, make_keys, port_config, port_limits, port_np

CFG = repro.SortConfig(use_pallas=False, capacity_factor=2.0)
LIMITS = repro.SortLimits(n_procs=4)
STATS = ("submitted", "completed", "failed", "cancelled", "rejected", "flushes",
         "flushed_requests", "direct_dispatches", "programs", "hits", "batches", "retries",
         "queue_depth", "occupancy_mean")


def _servers(config=CFG, limits=LIMITS, **kw):
    kw.setdefault("max_batch", 10_000)
    kw.setdefault("max_delay_ms", 600_000)
    return (rsortd.SortServer(config=config, limits=limits, **kw),
            tsortd.SortServer(config=port_config(config), limits=port_limits(limits),
                              device="cpu", **kw))


def _track(order, lock, fut, tag):
    def done(_):
        with lock:
            order.append(tag)

    fut.add_done_callback(done)
    return fut


def _same_keys(w, g) -> None:
    if isinstance(w, tuple):
        for a, b in zip(w, g):
            assert_bits_equal(np.asarray(a), port_np(b))
    else:
        assert_bits_equal(np.asarray(w), port_np(g))


def _requests(rng):
    """(method, args, kwargs) of a mixed traffic sample."""
    reqs = []
    for n in (300, 512, 400, 1000, 700):
        reqs.append(("submit", (make_keys(rng, n, "float32"),), {}))
    for n in (300, 450):
        reqs.append(("submit", (make_keys(rng, n, "float32"),), {"order": "desc"}))
        reqs.append(("submit", (make_keys(rng, n, "int32"),), {}))
    reqs.append(("submit", (make_keys(rng, 333, "uint16"),), {}))
    a, b = rng.integers(0, 1 << 8, 500).astype(np.int32), rng.integers(0, 1 << 10, 500)
    reqs.append(("submit", ((a, b.astype(np.int32)),),
                 {"order": ("asc", "desc"), "limits": repro.SortLimits(n_procs=4,
                                                                       key_bits=(8, 10))}))
    reqs.append(("submit_topk", (make_keys(rng, 400, "float32"), 7), {}))
    reqs.append(("submit_topk", (make_keys(rng, 400, "float32"), 5), {"largest": False,
                                                                      "order": "desc"}))
    q = np.array([-1.0, 0.0, 0.5, 3.0], np.float32)
    reqs.append(("submit_searchsorted", (make_keys(rng, 500, "float32"), q),
                 {"side": "right"}))
    reqs.append(("submit_percentile", (make_keys(rng, 500, "float32"), [1.0, 50.0, 99.5]), {}))
    reqs.append(("submit", (make_keys(rng, 600, "float32"),), {"want": "order"}))
    reqs.append(("submit", (make_keys(rng, 600, "float32"), make_keys(rng, 600, "int32")),
                 {}))
    return reqs


def _port_kwargs(kw):
    kw = dict(kw)
    if "limits" in kw:
        kw["limits"] = port_limits(kw["limits"])
    return kw


def test_mixed_traffic_matches_repro():
    reqs = _requests(np.random.default_rng(0))
    r, t = _servers()
    with r, t:
        rf = [getattr(r, m)(*a, **kw) for m, a, kw in reqs]
        tf = [getattr(t, m)(*a, **_port_kwargs(kw)) for m, a, kw in reqs]
        r.flush(timeout=120)
        t.flush(timeout=120)
        for (m, _, _), fw, fg in zip(reqs, rf, tf):
            w, g = fw.result(60), fg.result(60)
            _same_keys(w.keys, g.keys)
            if w.values is None:
                assert g.values is None
            else:
                assert_bits_equal(np.asarray(w.values), port_np(g.values))
            for name in ("coalesced", "retries", "want", "order", "multikey", "backend", "n"):
                assert getattr(g.meta, name) == getattr(w.meta, name), (m, name)
            assert g.meta.trace_id is not None and (g.meta.flush_id is None) == (
                w.meta.flush_id is None)
            if g.meta.coalesced:
                keys = g.keys if not isinstance(g.keys, tuple) else g.keys[0]
                assert keys.device.type == "cpu"
        ws, gs = r.stats(), t.stats()
    assert {k: gs[k] for k in STATS} == {k: ws[k] for k in STATS}
    assert gs["tenants"] == ws["tenants"] and gs["admission"] == ws["admission"]


def test_coalesced_overflow_walks_repros_ladder():
    rng = np.random.default_rng(1)
    cfg = repro.SortConfig(use_pallas=False, capacity_factor=0.3)
    datas = [make_keys(rng, n, "float32", distinct=3) for n in (400, 500, 512)]
    r, t = _servers(config=cfg, investigator=False)
    with r, t:
        rf = [r.submit(d) for d in datas]
        tf = [t.submit(d) for d in datas]
        r.flush(timeout=120)
        t.flush(timeout=120)
        for fw, fg in zip(rf, tf):
            w, g = fw.result(60), fg.result(60)
            _same_keys(w.keys, g.keys)
            assert g.meta.retries == w.meta.retries > 0
            assert g.meta.config.capacity_factor == w.meta.config.capacity_factor
        assert t.stats()["retries"] == r.stats()["retries"]


@pytest.mark.parametrize("weights", [{"slow": 1.0, "fast": 4.0}, {"a": 1.0, "b": 1.0}])
def test_weighted_fair_dispatch_order_matches_repro(weights):
    """A paused server drained by one forced flush resolves its group in
    fair order, so the resolution sequence is the dispatch order; a
    priority -1 request submitted last jumps the backlog."""
    rng = np.random.default_rng(2)
    names = list(weights)
    plan = [(names[0], 0)] * 6 + [(names[1], 0)] * 6 + [(names[0], -1)]
    datas = [make_keys(rng, 256 + 8 * i, "float32") for i in range(len(plan))]
    orders = []
    for server in _servers(tenants=weights):
        order, lock = [], threading.Lock()
        with server:
            futs = [_track(order, lock, server.submit(d, tenant=ten, priority=pri), i)
                    for i, (d, (ten, pri)) in enumerate(zip(datas, plan))]
            server.flush(timeout=120)
            for f in futs:
                f.result(60)
            tenants = server.stats()["tenants"]
        orders.append((order, tenants))
    (want, wt), (got, gt) = orders
    assert got == want and got[0] == len(plan) - 1
    assert gt == wt


def test_admission_errors_match_repro():
    rng = np.random.default_rng(3)
    x = make_keys(rng, 100, "float32")
    r, t = _servers(max_queue=2)
    with r, t:
        for s in (r, t):
            s.submit(x)
            s.submit(x)
        with pytest.raises(rsortd.QueueFullError) as we:
            r.submit(x)
        with pytest.raises(tsortd.QueueFullError) as ge:
            t.submit(x)
        assert str(ge.value) == str(we.value) == "sort queue full (2 pending requests)"
        assert 0 < ge.value.retry_after_ms <= 600_000
        assert t.stats()["rejected"] == r.stats()["rejected"] == 1
        r.flush(timeout=60)
        t.flush(timeout=60)
    lim = repro.SortLimits(n_procs=4, max_request_elems=50)
    r, t = _servers(limits=lim)
    with r, t:
        with pytest.raises(rsortd.RequestTooLargeError) as we:
            r.submit(x)
        with pytest.raises(tsortd.RequestTooLargeError) as ge:
            t.submit(x)
        assert str(ge.value) == str(we.value).replace("repro.sort", "repro_torch.sort")
        for bad in (dict(want="bogus"), dict(order="sideways")):
            with pytest.raises(ValueError):
                t.submit(x[:10], **bad)
        with pytest.raises(ValueError, match="single-key only"):
            t.submit_topk((x, x), 3)
        with pytest.raises(ValueError, match="needs the out-of-core backend"):
            t.submit(x[:10], stream_chunks=True)


def test_cancel_close_and_drain():
    rng = np.random.default_rng(4)
    t = tsortd.SortServer(config=port_config(CFG), limits=port_limits(LIMITS), device="cpu",
                          max_batch=10_000, max_delay_ms=600_000)
    keep = t.submit(make_keys(rng, 300, "float32"))
    drop = t.submit(make_keys(rng, 300, "float32"))
    assert drop.cancel() and drop.cancelled()
    t.close(timeout=60)  # drains what is queued
    assert not t._thread.is_alive()
    np.testing.assert_array_equal(keep.result(0).keys.numpy(),
                                  np.sort(keep.result(0).keys.numpy()))
    s = t.stats()
    assert (s["completed"], s["cancelled"], s["queue_depth"]) == (1, 1, 0)
    with pytest.raises(RuntimeError, match="SortServer is closed"):
        t.submit(make_keys(rng, 10, "float32"))


def test_stream_chunks_match_repro():
    rng = np.random.default_rng(5)
    x = make_keys(rng, 5000, "float32")
    lim = repro.SortLimits(n_procs=4, chunk_elems=1 << 11)
    r, t = _servers(limits=lim)
    with r, t:
        w = r.submit(x, where="stream", stream_chunks=True).result(120)
        g = t.submit(x, where="stream", stream_chunks=True).result(120)
        wc, gc = list(w.chunks()), list(g.chunks())
    assert len(gc) == len(wc)
    for a, b in zip(wc, gc):
        assert_bits_equal(a, port_np(b))
    assert g.meta.chunk_retries == w.meta.chunk_retries


def test_direct_dispatch_runs_alone_through_the_planner():
    rng = np.random.default_rng(6)
    x = make_keys(rng, 700, "float32")
    v = make_keys(rng, 700, "int32")
    r, t = _servers()
    with r, t:
        w1, g1 = r.submit(x, want="order"), t.submit(x, want="order")
        w2, g2 = r.submit(x, v, order="desc"), t.submit(x, v, order="desc")
        w3 = r.submit(x, where="stream", limits=repro.SortLimits(n_procs=4, chunk_elems=256))
        g3 = t.submit(x, where="stream", limits=port_limits(repro.SortLimits(
            n_procs=4, chunk_elems=256)))
        for w, g in ((w1, g1), (w2, g2), (w3, g3)):
            w, g = w.result(120), g.result(120)
            _same_keys(w.keys, g.keys)
            if w.values is not None:
                assert_bits_equal(np.asarray(w.values), port_np(g.values))
            assert g.meta.coalesced is None and g.meta.backend == w.meta.backend
            assert g.meta.retries == w.meta.retries
        s, ws = t.stats(), r.stats()
    assert s["direct_dispatches"] == ws["direct_dispatches"] == 3 and s["flushes"] == 0


def test_server_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsortd.SortServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.SortLibrary()
    from repro_torch.stream.service import SortService

    with pytest.raises(RuntimeError, match="device='cpu'"):
        SortService()
