"""``repro_torch.obs`` against ``repro.obs``: the metrics registry and its
Prometheus exposition (the semantics ``tests/test_obs.py`` checks for
``repro``, run on the port's copy), the metric names and labels of
``tests/metrics_schema.json``, and the phase traces of the sim and stream
backends: the same span names in the same order as ``repro``'s traces of
the same call, with equal per-processor counts, and a traced sort equal to
the untraced one bit for bit.
"""
import json
import pathlib
import threading

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch import obs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from torch_parity import assert_bits_equal, make_keys, port_config, port_limits, port_np

CFG = repro.SortConfig(use_pallas=False)
SCHEMA = pathlib.Path(__file__).resolve().parent / "metrics_schema.json"


def _sort(x, values=None, *, limits=None, **kw):
    return repro_torch.sort(x, values, config=port_config(CFG), limits=port_limits(limits),
                            device="cpu", **kw)


# ------------------------------------------------------------- registry


def test_counter_gauge_histogram_semantics():
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("t_total", "help", labels=("op",))
    c.labels(op="a").inc()
    c.labels(op="a").inc(2)
    c.labels(op="b").inc()
    assert c.labels(op="a").value == 3
    assert c.labels(op="b").value == 1
    with pytest.raises(ValueError):
        c.labels(op="a").inc(-1)

    g = reg.gauge("t_gauge", "help")
    g.set(5)
    g.set(2.5)
    assert g.value == 2.5

    h = reg.histogram("t_ms", "help", buckets=(1.0, 10.0, float("inf")))
    h.observe(0.5)
    h.observe(5.0)
    h.observe(100.0)
    text = reg.render()
    assert 't_ms_bucket{le="1"} 1' in text
    assert 't_ms_bucket{le="10"} 2' in text
    assert 't_ms_bucket{le="+Inf"} 3' in text
    assert "t_ms_sum 105.5" in text
    assert "t_ms_count 3" in text


def test_registry_idempotent_and_conflicts():
    reg = obs_metrics.MetricsRegistry()
    a = reg.counter("same_total", "help")
    b = reg.counter("same_total", "other help text is fine")
    assert a is b
    with pytest.raises(ValueError):
        reg.gauge("same_total", "help")
    with pytest.raises(ValueError):
        reg.counter("same_total", "help", labels=("x",))


def test_exposition_parses_and_escapes():
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("esc_total", "help", labels=("path",))
    c.labels(path='a"b\\c\nd').inc()
    text = reg.render()
    line = [ln for ln in text.splitlines() if ln.startswith("esc_total{")][0]
    assert line == 'esc_total{path="a\\"b\\\\c\\nd"} 1'
    for ln in text.splitlines():
        if not ln.startswith("#"):
            float(ln.rpartition(" ")[2])


def test_describe_is_stable_schema():
    reg = obs_metrics.MetricsRegistry()
    reg.counter("a_total", "h", labels=("x", "y"))
    reg.histogram("b_ms", "h")
    desc = reg.describe()
    assert {"name": "a_total", "type": "counter", "labels": ["x", "y"]} in desc
    assert {"name": "b_ms", "type": "histogram", "labels": []} in desc
    assert desc == sorted(desc, key=lambda d: d["name"])


def test_metric_mutation_thread_safety():
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("race_total", "h")

    def worker():
        for _ in range(1000):
            c.inc()

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert c.value == 8000


def test_port_metrics_follow_the_schema():
    """Every metric family the port registers, the serve tier's ``sortd_*``
    ones included, has repro's name, type and labels
    (tests/metrics_schema.json, which pins repro's registry), and once the
    serve tier is imported the port registers all of them."""
    from repro_torch.core import planner  # noqa: F401  (registers the sort's metrics)
    from repro_torch.serve import sortd  # noqa: F401  (the serve tier, tune and flight)

    schema = {d["name"]: d for d in json.loads(SCHEMA.read_text())}
    port = obs_metrics.REGISTRY.describe()
    assert len(schema) == 28
    assert {d["name"] for d in port} == set(schema)
    for d in port:
        assert schema[d["name"]] == d, d


def test_sort_counter_and_ladder_counter_count():
    x = make_keys(np.random.default_rng(1), 4096, "int32", distinct=4)
    sorts = obs_metrics.REGISTRY.counter("repro_sorts_total", labels=("backend",))
    ladder = obs_metrics.REGISTRY.counter("repro_overflow_ladder_retries_total")
    before = (sorts.labels(backend="sim").value, sorts.labels(backend="stream").value,
              ladder.value)
    out = repro_torch.sort(x, config=repro_torch.SortConfig(use_pallas=False,
                                                            capacity_factor=0.3),
                           investigator=False, limits=repro_torch.SortLimits(
                               raise_on_overflow=False), device="cpu")
    _sort(x, where="stream", limits=repro.SortLimits(chunk_elems=1024)).keys
    assert out.meta.retries > 0
    assert sorts.labels(backend="sim").value == before[0] + 1
    assert sorts.labels(backend="stream").value == before[1] + 1
    assert ladder.value == before[2] + out.meta.retries


# -------------------------------------------------------------- tracing


CASES = [("sim", {}), ("sim", {"want": "order"}), ("sim", {"order": "desc"}),
         ("stream", {}), ("stream", {"want": "order"}), ("stream", {"order": "desc"}),
         ("stream", {"limits": "host"})]


@pytest.mark.parametrize("where,kw", CASES)
def test_trace_spans_match_repro(where, kw):
    """The same span names in the same order as repro's trace of the same
    call, with equal per-processor counts (per shard for sim; per run,
    per bucket and per bucket segment for the stream), and the same
    output as the untraced call."""
    kw = dict(kw)
    x = make_keys(np.random.default_rng(2), 6000, "float32", distinct=500)
    lim = dict(n_procs=4, chunk_elems=2048, stream_threshold=None)
    if kw.pop("limits", None) == "host":
        lim["decode"] = "host"
    traced = repro.SortLimits(trace=True, **lim)
    r = repro.sort(x, where=where, config=CFG, limits=traced, **kw)
    t = _sort(x, where=where, limits=traced, **kw)
    assert_bits_equal(r.keys, port_np(t.keys))
    rs, ts = r.meta.trace.spans, t.meta.trace.spans
    assert [s.name for s in ts] == [s.name for s in rs]
    assert [s.attrs.get("per_proc") for s in ts] == [s.attrs.get("per_proc") for s in rs]
    assert t.meta.trace.frozen and t.meta.trace.labels == {"backend": where}
    plain = _sort(x, where=where, limits=repro.SortLimits(**lim), **kw)
    assert plain.meta.trace is None
    assert torch.equal(plain.keys, t.keys)
    if t.values is not None:
        assert torch.equal(plain.values, t.values)
    if where == "sim":
        exch = next(s for s in ts if s.name == "exchange")
        assert sum(exch.attrs["per_proc"]) == x.size and exch.attrs["imbalance"] >= 1.0
        split = next(s for s in ts if s.name == "splitter")
        assert split.attrs["overflowed"] is False


def test_traced_kv_and_tuple_sorts_equal_untraced():
    rng = np.random.default_rng(3)
    keys = make_keys(rng, 5000, "uint16", distinct=9) + np.uint16(1)
    vals = make_keys(rng, 5000, "float32")
    for kw in ({"order": "desc"}, {"where": "stream"}):
        lim = dict(n_procs=4, chunk_elems=1024, stream_threshold=None)
        a = _sort(keys, vals, limits=repro.SortLimits(trace=True, **lim), **kw)
        b = _sort(keys, vals, limits=repro.SortLimits(**lim), **kw)
        assert torch.equal(a.keys, b.keys) and torch.equal(a.values, b.values)
        assert a.meta.trace.frozen
    ids = rng.integers(0, 30, 5000).astype(np.int32)
    f = make_keys(rng, 5000, "float32")
    pairs = {"packed": (ids, rng.integers(0, 1000, 5000).astype(np.int32)), "lsd": (ids, f)}
    for where in ("sim", "stream"):
        for mk, pair in pairs.items():
            lim = repro.SortLimits(trace=True, n_procs=4, chunk_elems=1024, multikey=mk)
            r = repro.sort(pair, where=where, config=CFG, limits=lim, want="order")
            t = _sort(pair, where=where, limits=lim, want="order")
            assert_bits_equal(r.order(), port_np(t.order()))
            assert [s.name for s in t.meta.trace.spans] == [s.name for s in r.meta.trace.spans]
            assert t.meta.trace.frozen


def test_coverage_of_a_traced_sort():
    """The spans cover the wall window of a traced sort (repro's gate,
    tests/test_obs.py: coverage >= 0.95), on the sim and the stream; at
    2^16 keys so that the CPU's sort, not the Python between spans, sets
    the window (the best of three runs)."""
    x = np.random.default_rng(4).normal(0, 1, 1 << 16).astype(np.float32)
    for where in ("sim", "stream"):
        best = 0.0
        for _ in range(3):
            out = _sort(x, where=where, limits=repro.SortLimits(
                trace=True, n_procs=4, chunk_elems=1 << 13, stream_threshold=None))
            out.keys
            best = max(best, out.meta.trace.coverage())
        assert best >= 0.95, (where, best)
        assert out.meta.trace.phase_totals()["local_sort"] > 0


def test_untraced_sort_has_no_trace():
    x = np.random.default_rng(5).normal(0, 1, 1 << 10).astype(np.float32)
    assert _sort(x).meta.trace is None
    assert _sort(x, where="stream", limits=repro.SortLimits(chunk_elems=256)).meta.trace is None


def test_trace_frozen_after_materialization():
    x = np.random.default_rng(6).normal(0, 1, 5000).astype(np.float32)
    out = _sort(x, where="stream", limits=repro.SortLimits(trace=True, n_procs=4,
                                                           chunk_elems=1024))
    tr = out.meta.trace
    assert not tr.frozen  # the stream's passes run when the keys are read
    out.keys
    assert tr.frozen
    n_spans = len(tr.spans)
    with pytest.raises(RuntimeError):
        with tr.span("late"):
            pass
    with obs_tracing.maybe_span(tr, "late") as sp:
        sp.set(ignored=1)
    assert len(tr.spans) == n_spans


def test_ambient_trace_context():
    x = np.random.default_rng(7).normal(0, 1, 1 << 10).astype(np.float32)
    with obs.trace(job="ambient") as tr:
        out = _sort(x)
        out.keys
        assert out.meta.trace is tr
        assert not tr.frozen
        _sort(x, where="stream", limits=repro.SortLimits(chunk_elems=256)).keys
    assert tr.frozen
    assert tr.labels == {"job": "ambient", "backend": "sim"}
    names = [s.name for s in tr.spans]
    assert names.count("local_sort") == 2 and "merge" in names
    assert obs_tracing.current_trace() is None


def test_chrome_export(tmp_path):
    x = np.random.default_rng(8).normal(0, 1, 1 << 10).astype(np.float32)
    out = _sort(x, limits=repro.SortLimits(trace=True, n_procs=4))
    path = tmp_path / "trace.json"
    out.meta.trace.to_chrome_file(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in complete} >= {"local_sort", "exchange"}
    for e in complete:
        assert e["dur"] >= 0 and e["ts"] >= 0


def test_phase_histogram_published():
    x = np.random.default_rng(9).normal(0, 1, 1 << 10).astype(np.float32)
    fam = obs_metrics.REGISTRY.histogram("repro_sort_phase_seconds", "",
                                         labels=("backend", "phase"))
    sim_child = fam.labels(backend="sim", phase="local_sort")
    merge_child = fam.labels(backend="stream", phase="merge")
    before = sim_child._count, merge_child._count
    _sort(x, limits=repro.SortLimits(trace=True, n_procs=4))
    out = _sort(x, where="stream", limits=repro.SortLimits(trace=True, chunk_elems=256))
    assert merge_child._count == before[1]  # nothing published before materialization
    out.keys
    assert sim_child._count == before[0] + 1 and sim_child._sum > 0
    assert merge_child._count == before[1] + 4  # one span per bucket


def test_disabled_suppresses_everything():
    x = np.random.default_rng(10).normal(0, 1, 1 << 10).astype(np.float32)
    c = obs_metrics.counter("repro_torch_test_disabled_total", "h")
    with obs.disabled():
        out = _sort(x, limits=repro.SortLimits(trace=True))
        assert out.meta.trace is None
        c.inc()
        assert obs_tracing.current_trace() is None
    assert c.value == 0
    c.inc()
    assert c.value == 1


def test_profiling_annotate_is_a_switch(monkeypatch):
    """annotate() is a no-op unless profiling is on, and then a
    torch.profiler range of that name."""
    from repro_torch.obs import profiling

    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: (calls.append(name), threading.Lock())[1])
    profiling.set_profiling(False)
    with profiling.annotate("off"):
        pass
    profiling.set_profiling(True)
    try:
        x = np.random.default_rng(11).normal(0, 1, 3000).astype(np.float32)
        _sort(x, where="stream", limits=repro.SortLimits(chunk_elems=1024)).keys
    finally:
        profiling.set_profiling(False)
    assert calls == ["repro.stream.stage_chunk"] * 3
