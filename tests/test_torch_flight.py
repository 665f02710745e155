"""The port's flight recorder, SLOs and ``obsctl`` against ``repro``'s:
``tests/check_flight_schema.py`` run on the port's recorder, snapshots of
a served workload in the pinned shape with every flush linked to its
requests, ``SLOTracker`` giving ``repro``'s numbers for the same latency
feed, the recorder's sampler, burst detector and incident dumps, and the
``obsctl`` subcommands giving the same structure on a port snapshot as
``repro``'s on ``repro``'s.
"""
import json
import re
import sys

import numpy as np
import pytest

import repro
from repro import obsctl as robsctl
from repro.obs import flight as rflight
from repro.obs import slo as rslo
from repro.serve import sortd as rsortd
from repro_torch import obs as tobs
from repro_torch import obsctl as tobsctl
from repro_torch.obs import flight as tflight
from repro_torch.obs import slo as tslo
from repro_torch.serve import sortd as tsortd
from torch_parity import make_keys, port_config, port_limits

import check_flight_schema

CFG = repro.SortConfig(use_pallas=False, capacity_factor=2.0)
LIMITS = repro.SortLimits(n_procs=4)
SCHEMA = json.loads(check_flight_schema.SCHEMA_PATH.read_text())


def test_check_flight_schema_accepts_the_port(monkeypatch):
    """The repo's own checker, run against the port's recorder."""
    monkeypatch.setitem(sys.modules, "repro.obs", tobs)
    got = check_flight_schema.current_schema()
    assert not check_flight_schema.diff(SCHEMA, got)


def _workload(pkg_sortd, recorder, **port_kw):
    """A few coalesced requests in two buckets, one direct argsort; the
    recorder's snapshot after the drain."""
    recorder.reset()
    rng = np.random.default_rng(0)
    kw = dict(config=CFG, limits=LIMITS) if not port_kw else dict(
        config=port_config(CFG), limits=port_limits(LIMITS), **port_kw)
    with pkg_sortd.SortServer(max_batch=10_000, max_delay_ms=600_000, **kw) as srv:
        futs = [srv.submit(make_keys(rng, n, "float32")) for n in (300, 400, 500)]
        futs.append(srv.submit(make_keys(rng, 2000, "float32")))
        futs.append(srv.submit(make_keys(rng, 300, "float32"), want="order"))
        srv.flush(timeout=120)
        for f in futs:
            f.result(60)
    return recorder.snapshot()


def test_served_snapshot_has_the_pinned_shape_and_links():
    snap = _workload(tsortd, tflight.RECORDER, device="cpu")
    assert snap["schema"] == SCHEMA["schema_version"]
    assert sorted(snap) == SCHEMA["top_level_fields"]
    assert all(sorted(q) == SCHEMA["request_fields"] for q in snap["requests"])
    assert all(sorted(f) == SCHEMA["flush_fields"] for f in snap["flushes"])
    assert sorted(snap["traces"][0]) == SCHEMA["trace_fields"]
    by_id = {q["trace_id"]: q for q in snap["requests"]}
    for f in snap["flushes"]:
        assert f["requests"] and all(by_id[t]["flush_id"] == f["flush_id"]
                                     for t in f["requests"])
    (direct,) = [q for q in snap["requests"] if q["kind"] == "direct"]
    assert direct["flush_id"] is None and direct["sampled"] and direct["phases"]
    json.dumps(snap)  # serializable as it is
    want = _workload(rsortd, rflight.RECORDER)
    for field in ("requests", "flushes"):
        strip = ("trace_id", "flush_id", "requests", "t_submit", "t_dispatch", "t_done", "t0",
                 "queue_wait_ms", "execute_ms", "total_ms", "phases")

        def shape(rows):
            return sorted(json.dumps({k: v for k, v in r.items() if k not in strip},
                                     sort_keys=True) for r in rows)

        assert shape(snap[field]) == shape(want[field])


def _feed(seed):
    rng = np.random.default_rng(seed)
    return [(None if rng.random() < 0.02 else float(rng.exponential(20.0)),
             bool(rng.random() < 0.03)) for _ in range(400)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cfg", [dict(), dict(threshold_ms=10.0, error_budget=0.05, window=64)])
def test_slo_tracker_gives_repros_numbers(seed, cfg):
    r = rslo.SLOTracker(rslo.SLOConfig(name=f"t{seed}", **cfg))
    t = tslo.SLOTracker(tslo.SLOConfig(name=f"t{seed}", **cfg))
    for latency, error in _feed(seed):
        assert t.observe(latency, error=error) == r.observe(latency, error=error)
        assert t.snapshot() == r.snapshot()
    assert (t.violation_ratio, t.burn_rate) == (r.violation_ratio, r.burn_rate)
    adapt = repro.tune.AdaptConfig(target_p99_ms=12.5)
    assert tslo.SLOConfig.from_adapt(adapt) == tslo.SLOConfig(name="serve_p99",
                                                              threshold_ms=12.5,
                                                              error_budget=0.01)
    for bad in (dict(threshold_ms=0), dict(error_budget=1.0), dict(window=0)):
        with pytest.raises(ValueError) as we:
            rslo.SLOConfig(**bad)
        with pytest.raises(ValueError) as ge:
            tslo.SLOConfig(**bad)
        assert str(ge.value) == str(we.value)


def test_recorder_sampler_bursts_and_dumps_match_repro(tmp_path):
    outs = []
    for pkg, sub in ((rflight, "r"), (tflight, "t")):
        rec = pkg.FlightRecorder(sample_every=4, burst_threshold=3, burst_window_s=1.0,
                                 min_dump_interval_s=100.0)
        samples = [rec.sample() for _ in range(9)]
        bursts = [rec.record_rejection(t) for t in (0.0, 0.5, 0.9, 5.0, 5.1, 5.2)]
        paths = [rec.anomaly("queue_full_burst", {"max_queue": 2},
                             flight_dir=str(tmp_path / sub)) for _ in range(2)]
        with pytest.raises(KeyError):
            rec.anomaly("bogus")
        snap = rec.incidents[-1]
        outs.append((samples, bursts, [p is None for p in paths],
                     [p and p.rsplit("/", 1)[1] for p in paths],
                     snap["kind"], snap["anomaly_counts"], sorted(snap)))
        rec.enabled = False
        assert rec.anomaly("deadline_miss") is None and not rec.sample()
    assert outs[0] == outs[1]


def _canon(events):
    """Chrome events with ids and times taken out: names, phases, arg keys."""
    ids = re.compile(r"[rf][0-9a-f]{4}-[0-9a-f]{8}")
    return sorted((ids.sub("ID", e["name"]) if e["ph"] == "X" else
                   ids.sub("ID", e["args"]["name"]).replace("repro_torch.", "repro."),
                   e["ph"], tuple(sorted(e.get("args", {}))))
                  for e in events)


def test_obsctl_reads_a_port_snapshot_as_repros_reads_repros(tmp_path, capsys):
    snaps = {"t": _workload(tsortd, tflight.RECORDER, device="cpu"),
             "r": _workload(rsortd, rflight.RECORDER)}
    for k, snap in snaps.items():
        (tmp_path / f"{k}.json").write_text(json.dumps(snap))
    assert _canon(tobsctl.snapshot_to_chrome(snaps["t"])) == \
           _canon(robsctl.snapshot_to_chrome(snaps["r"]))
    tid = snaps["t"]["requests"][0]["trace_id"]
    one = tobsctl.snapshot_to_chrome(snaps["t"], trace_id=tid)
    assert any(e.get("args", {}).get("trace_id") == tid for e in one)

    lines = {}
    for k, mod in (("t", tobsctl), ("r", robsctl)):
        assert mod.main(["slow", str(tmp_path / f"{k}.json"), "-n", "3"]) == 0
        lines[k] = capsys.readouterr().out.splitlines()
        assert mod.main(["export", str(tmp_path / f"{k}.json"), "--out",
                         str(tmp_path / f"{k}.trace.json")]) == 0
        capsys.readouterr()
    assert lines["t"][0] == lines["r"][0] and len(lines["t"]) == len(lines["r"]) == 4
    doc = json.loads((tmp_path / "t.trace.json").read_text())
    assert doc["displayTimeUnit"] == "ms" and doc["traceEvents"]

    # scrape a demo burst on the CPU, then diff two scrapes
    a, b, s = tmp_path / "a.txt", tmp_path / "b.txt", tmp_path / "snap.json"
    assert tobsctl.main(["scrape", "--demo", "--device", "cpu", "--out", str(a),
                         "--snapshot", str(s)]) == 0
    assert tobsctl.main(["scrape", "--out", str(b)]) == 0
    assert tobsctl.main(["diff", str(a), str(b)]) == 0
    capsys.readouterr()
    text = a.read_text()
    assert "sortd_requests_total" in text and "repro_program_cache_builds_total" in text
    assert sorted(json.loads(s.read_text())) == SCHEMA["top_level_fields"]


def test_queue_full_burst_leaves_an_incident_snapshot(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FLIGHT_DIR", str(tmp_path))
    x = make_keys(np.random.default_rng(1), 64, "float32")
    details = []
    for pkg_sortd, rec, kw in ((rsortd, rflight.RECORDER, {}),
                               (tsortd, tflight.RECORDER, {"device": "cpu"})):
        rec.reset()
        conf = dict(config=CFG, limits=LIMITS) if not kw else dict(
            config=port_config(CFG), limits=port_limits(LIMITS), **kw)
        with pkg_sortd.SortServer(max_queue=1, max_batch=10_000, max_delay_ms=600_000,
                                  **conf) as srv:
            srv.submit(x)
            for _ in range(rec.burst_threshold):
                with pytest.raises(pkg_sortd.QueueFullError):
                    srv.submit(x)
            srv.flush(timeout=60)
        snap = rec.incidents[-1]
        details.append((snap["kind"], sorted(snap["detail"]), snap["anomaly_counts"]))
    assert details[0] == details[1] and details[1][0] == "queue_full_burst"
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 2 and all(f.startswith("incident_queue_full_burst_") for f in files)
    assert tobsctl.main(["slow", str(tmp_path)]) == 0


def test_disabled_switches_the_recorder_off():
    tflight.RECORDER.reset()
    with tobs.disabled():
        tflight.RECORDER.record_request({"trace_id": "x"})
        assert tflight.RECORDER.anomaly("deadline_miss") is None
    assert tflight.RECORDER.snapshot()["requests"] == []
    assert tflight.RECORDER.enabled
