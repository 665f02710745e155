"""``repro_torch.tune`` against ``repro.tune``: the same observations give
the same store document (and either package loads the other's file), the
same predictions and choices, the same plans under an ambient tuner
(backend, ``cost_source``, reasons, chunk size), the same measured ladder
start, and the adaptive controller walks the same knob path for the same
latency feed. ``tests/check_tune_schema.py`` checks the port's store.
"""
import contextlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro import tune as rtune
from repro_torch import tune as ttune
from repro_torch.obs import flight as tflight
from torch_parity import assert_sort_equal, port_config, port_limits, sort_both

import check_tune_schema

CFG = repro.SortConfig(use_pallas=False)
BENCH = pathlib.Path(__file__).resolve().parents[1] / "BENCH_api.json"

# (op, backend, dtype, n, us, weight): the port passes torch dtypes where
# repro passes numpy names
OBSERVATIONS = [
    ("sort", "sim", "float32", 1 << 12, 100.0, 2.0),
    ("sort", "sim", "float32", 1 << 14, 400.0, 2.0),
    ("sort", "sim", "float32", 1 << 16, 1600.0, 2.0),
    ("sort", "stream", "float32", 1 << 12, 150.0, 2.0),
    ("sort", "stream", "float32", 1 << 14, 150.0, 2.0),
    ("sort", "stream", "float32", 1 << 16, 150.0, 2.0),
    ("sort", "sim", "float32", 1 << 14, 380.0, 1.0),
    ("sort", "sim", "int32", 5000, 90.0, 1.0),
    ("chunk_sort", "stream", "float32", 1 << 11, 40.0, 1.0),
    ("chunk_sort", "stream", "float32", 1 << 12, 60.0, 1.0),
    ("chunk_sort", "stream", "float32", 1 << 13, 80.0, 1.0),
    ("chunk_sort", "stream", "float32", 1 << 13, 70.0, 1.0),
    ("chunk_sort", "stream", "float32", 1 << 12, 55.0, 1.0),
    ("chunk_sort", "stream", "float32", 1 << 11, 45.0, 1.0),
    ("sort", "sim", "float32", 0, 10.0, 1.0),          # ignored: n = 0
    ("sort", "sim", "float32", 1 << 12, float("nan"), 1.0),  # ignored
]
TORCH = {"float32": torch.float32, "int32": torch.int32}


def _stores(obs=OBSERVATIONS):
    r, t = rtune.TuneStore(), ttune.TuneStore()
    for op, backend, dtype, n, us, w in obs:
        r.observe(op, backend, dtype, n, us, weight=w)
        t.observe(op, backend, TORCH[dtype], n, us, weight=w)
    return r, t


def test_same_observations_give_the_same_store_document():
    r, t = _stores()
    assert json.dumps(t.to_json(), sort_keys=True) == json.dumps(r.to_json(), sort_keys=True)
    assert len(t) == len(r) and t.total_count == r.total_count
    for key in ("sort|sim|float32", "chunk_sort|stream|float32"):
        op, backend, dtype = key.split("|")
        assert t.samples(op, backend, TORCH[dtype]) == r.samples(op, backend, dtype)


def test_store_files_load_in_either_package(tmp_path):
    r, t = _stores()
    t.save(str(tmp_path / "port.json"))
    r.save(str(tmp_path / "repro.json"))
    assert rtune.TuneStore.load(str(tmp_path / "port.json")).to_json() == r.to_json()
    assert ttune.TuneStore.load(str(tmp_path / "repro.json")).to_json() == t.to_json()
    (tmp_path / "old.json").write_text(json.dumps({"schema": 0, "keys": {}}))
    texts = []
    for pkg in (rtune, ttune):
        with pytest.raises(pkg.TuneStoreError) as e:
            pkg.TuneStore.load(str(tmp_path / "old.json"))
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    for pkg in (rtune, ttune):
        store, reason = pkg.TuneStore.load_or_cold(str(tmp_path / "absent.json"))
        assert len(store) == 0 and reason == "cold: no store file"


@pytest.mark.parametrize("n", [1 << 10, 3000, 1 << 13, 1 << 15, 1 << 18])
def test_predict_and_choose_agree(n):
    r, t = _stores()
    rm, tm = rtune.CostModel(r), ttune.CostModel(t)
    for op, backend in (("sort", "sim"), ("sort", "stream"), ("chunk_sort", "stream"),
                        ("sort", "mesh")):
        want, got = rm.predict(op, backend, "float32", n), tm.predict(op, backend,
                                                                      torch.float32, n)
        if want is None:
            assert got is None
            continue
        assert (got.us, got.confidence, got.extrapolated) == (want.us, want.confidence,
                                                              want.extrapolated)
    for conf in (0.3, 0.5, 0.9):
        w, wp = rm.choose("sort", ("sim", "stream"), "float32", n, min_confidence=conf)
        g, gp = tm.choose("sort", ("sim", "stream"), torch.float32, n, min_confidence=conf)
        assert g == w
        assert {b: (p.us, p.confidence) for b, p in gp.items()} == \
               {b: (p.us, p.confidence) for b, p in wp.items()}


def _plans(x, store_pair, where=None, **limits_kw):
    limits = repro.SortLimits(chunk_elems=1 << 12, n_procs=4, **limits_kw)
    r_store, t_store = store_pair
    with rtune.active(r_store):
        want = repro.plan(x, where=where, limits=limits, config=CFG)
    with ttune.active(t_store):
        got = repro_torch.plan(x, where=where, limits=port_limits(limits),
                               config=port_config(CFG), device="cpu")
    return want, got


@pytest.mark.parametrize("n", [1 << 10, 1 << 12, 1 << 14, 1 << 15])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("where", [None, "stream"])
def test_plans_agree_under_an_ambient_tuner(n, seeded, where):
    """The same store on both sides: the same backend, cost source,
    predictions, reasons (``explain``'s cost lines too) and chunk size;
    a cold store plans exactly as no tuner does."""
    x = np.random.default_rng(n).normal(0, 1, n).astype(np.float32)
    pair = _stores() if seeded else (rtune.TuneStore(), ttune.TuneStore())
    want, got = _plans(x, pair, where, stream_threshold=1 << 13)
    assert (got.backend, got.cost_source, got.chunk_elems) == (want.backend, want.cost_source,
                                                               want.chunk_elems)
    assert got.reasons == want.reasons
    assert got.cost_predicted == want.cost_predicted
    got_cost = [ln for ln in got.explain().splitlines() if "predicted" in ln or "cost:" in ln]
    want_cost = [ln for ln in want.explain().splitlines() if "predicted" in ln or "cost:" in ln]
    assert got_cost == want_cost
    if not seeded:  # a cold store plans as no tuner does
        bare = repro_torch.plan(x, where=where, config=port_config(CFG), device="cpu",
                                limits=port_limits(repro.SortLimits(
                                    chunk_elems=1 << 12, n_procs=4, stream_threshold=1 << 13)))
        assert (bare.backend, bare.reasons, bare.chunk_elems) == (got.backend, got.reasons,
                                                                  got.chunk_elems)
        assert got.cost_source == "static"


def test_seeded_model_overrides_and_confirms_the_static_rule():
    pair = _stores()
    x = np.random.default_rng(1).normal(0, 1, 1 << 14).astype(np.float32)
    want, got = _plans(x, pair, stream_threshold=1 << 20)
    assert got.cost_source == want.cost_source == "model"
    assert got.backend == want.backend == "stream"
    assert any("overrides the static rule" in r for r in got.reasons)
    want, got = _plans(x[:1 << 12], pair, stream_threshold=1 << 20)
    assert got.backend == want.backend == "sim"
    assert any("confirms the static rule" in r for r in got.reasons)


@pytest.mark.parametrize("tuned", [False, True])
def test_measured_ladder_start_matches_repro(tuned):
    """2^14 ints at capacity_factor 0.15 (``repro``'s own case): the
    geometric ladder takes more than one retry, the measured start one;
    the same retries, final capacity and bits on both sides."""
    x = np.random.default_rng(7).integers(0, 1 << 14, 1 << 14).astype(np.int32)
    cfg = repro.SortConfig(use_pallas=False, capacity_factor=0.15)
    limits = repro.SortLimits(n_procs=8)
    if tuned:
        with rtune.active(rtune.TuneStore()), ttune.active(ttune.TuneStore()):
            r, t = sort_both(x, config=cfg, limits=limits)
    else:
        r, t = sort_both(x, config=cfg, limits=limits)
    assert_sort_equal(r, t)
    assert t.meta.config.capacity_factor == r.meta.config.capacity_factor
    assert t.meta.retries == (1 if tuned else r.meta.retries)
    if not tuned:
        assert t.meta.retries > 1
    np.testing.assert_array_equal(t.keys.numpy(), np.sort(x))


def test_measured_start_in_the_stream_matches_repro():
    """The stream's per-chunk ladders start where each chunk's counts say
    when a tuner is ambient: the same per-chunk retries as ``repro``."""
    x = np.random.default_rng(3).integers(0, 1 << 13, 1 << 13).astype(np.int32)
    cfg = repro.SortConfig(use_pallas=False, capacity_factor=0.15)
    limits = repro.SortLimits(n_procs=4, chunk_elems=1 << 11)
    for tuned in (False, True):
        with rtune.active(rtune.TuneStore()) if tuned else contextlib.nullcontext():
            r = repro.sort(x, where="stream", config=cfg, limits=limits)
            rk = r.keys
        with ttune.active(ttune.TuneStore()) if tuned else contextlib.nullcontext():
            t = repro_torch.sort(x, where="stream", config=port_config(cfg),
                                 limits=port_limits(limits), device="cpu")
            tk = t.keys
        np.testing.assert_array_equal(tk.numpy(), rk)
        assert t.meta.chunk_retries == r.meta.chunk_retries
        assert max(t.meta.chunk_retries) == 1 if tuned else max(t.meta.chunk_retries) > 1


def test_online_recording_feeds_the_same_keys():
    """Sorts under ``active`` record the same (op, backend, dtype) keys and
    bins with the same counts as ``repro``'s (the times differ): the sim's
    wall time and, for a stream, its per-chunk cost."""
    x = np.random.default_rng(2).normal(0, 1, 1 << 12).astype(np.float32)
    limits = repro.SortLimits(chunk_elems=1 << 10, n_procs=4)
    r_store, t_store = rtune.TuneStore(), ttune.TuneStore()
    with rtune.active(r_store):
        _ = repro.sort(x, where="sim", config=CFG).keys
        _ = repro.sort(x, where="stream", config=CFG, limits=limits).keys
    with ttune.active(t_store):
        _ = repro_torch.sort(x, where="sim", config=port_config(CFG), device="cpu").keys
        _ = repro_torch.sort(x, where="stream", config=port_config(CFG),
                             limits=port_limits(limits), device="cpu").keys

    def shape(store):
        return {k: {b: c["count"] for b, c in bins.items()} for k, bins in store.keys.items()}

    assert shape(t_store) == shape(r_store)
    assert set(t_store.keys) == {"sort|sim|float32", "sort|stream|float32",
                                 "chunk_sort|stream|float32"}


def test_record_sort_parks_the_prediction_in_the_flight_recorder():
    pair = _stores()
    x = np.random.default_rng(4).normal(0, 1, 1 << 12).astype(np.float32)
    tflight.RECORDER.reset()
    with ttune.active(pair[1]):
        out = repro_torch.sort(x, config=port_config(CFG), device="cpu",
                               limits=port_limits(repro.SortLimits(n_procs=4)))
    assert out.meta.plan.cost_source == "model"
    (pred,) = tflight.RECORDER.snapshot()["predictions"]
    assert (pred["op"], pred["backend"], pred["n"]) == ("sort", out.meta.backend, 1 << 12)
    assert pred["predicted_us"] == out.meta.plan.cost_predicted[out.meta.backend]["us"]
    assert out.meta.t_start is None  # recorded once, at completion


def test_configure_seeds_as_repro(tmp_path):
    """``configure`` with a missing store file and ``bench`` history
    builds the same store as ``repro``'s, and installs it."""
    try:
        r = rtune.configure(str(tmp_path / "r.json"), bench=[str(BENCH)])
        t = ttune.configure(str(tmp_path / "t.json"), bench=[str(BENCH)])
        assert ttune.current() is t
        assert json.dumps(t.store.to_json(), sort_keys=True) == \
               json.dumps(r.store.to_json(), sort_keys=True)
        t.save()
        assert ttune.TuneStore.load(str(tmp_path / "t.json")).to_json() == t.store.to_json()
    finally:
        rtune.disable()
        ttune.disable()
    assert ttune.current() is None


def _feed(seed: int):
    rng = np.random.default_rng(seed)
    return [(float(rng.uniform(0.5, 80.0)), int(rng.integers(0, 40)), int(rng.integers(0, 20)))
            for _ in range(300)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg_kw", [{}, dict(target_p99_ms=5.0, patience=1, min_samples=1,
                                             min_batch=4, max_batch=32)])
def test_adaptive_controller_walks_repro_knob_path(seed, cfg_kw):
    r = rtune.AdaptiveController(rtune.AdaptConfig(**cfg_kw), delay_ms=20.0, batch=16)
    t = ttune.AdaptiveController(ttune.AdaptConfig(**cfg_kw), delay_ms=20.0, batch=16)
    for p99, completed, depth in _feed(seed):
        assert t.update(p99, completed=completed, queue_depth=depth) == \
               r.update(p99, completed=completed, queue_depth=depth)
        assert (t.delay_ms, t.batch, t.adjustments, t.bound_saturations, t.saturated_at) == \
               (r.delay_ms, r.batch, r.adjustments, r.bound_saturations, r.saturated_at)
    with pytest.raises(ValueError) as e:
        ttune.AdaptConfig(step=1.0)
    assert str(e.value) == "adapt step must be > 1"


def test_check_tune_schema_accepts_the_port(monkeypatch):
    """The repo's own checker, run against the port's tune package."""
    monkeypatch.setitem(sys.modules, "repro.tune", ttune)
    got = check_tune_schema.current_schema()
    assert not check_tune_schema.diff(json.loads(check_tune_schema.SCHEMA_PATH.read_text()),
                                      got)
    assert got["cost_model_version"] == rtune.COST_MODEL_VERSION


def test_no_tuner_means_no_timing_state():
    x = np.random.default_rng(5).normal(0, 1, 1 << 10).astype(np.float32)
    assert ttune.current() is None
    out = repro_torch.sort(x, config=port_config(CFG), device="cpu")
    assert out.meta.t_start is None and out.meta.plan.cost_source == "static"
    out = repro_torch.sort(x, where="stream", config=port_config(CFG), device="cpu")
    assert out.meta.t_start is None and out.meta.plan.cost_predicted is None
