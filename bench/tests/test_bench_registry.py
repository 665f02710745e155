"""Finding cells, configurations, traffic and metrics by name, and the
shape of BENCHMARK.json against the benchmark's contract."""
import json
import re
import shutil

import benchkit
import pytest

from benchlib import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def spec():
    return json.loads((benchkit.ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_limits(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "bench/run.py"] and spec["paths"] == ["bench"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    # a full check of 24 cells fits its 43200 seconds
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (spec["run_seconds"] + 60)
    assert len((benchkit.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    four = [w for w in spec["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(spec["workloads"]) // 4)


def test_names_units_and_keys(spec):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (benchkit.ROOT / c["file"]).exists()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:  # each listed cell reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("kind", ["configs", "traffic", "workloads", "metrics"])
def test_every_named_piece_has_its_file(spec, kind):
    if kind == "configs":
        for c in spec["configs"]:
            assert registry.config(c["name"])["name"] == c["name"]
            assert registry.config(c["name"])["kind"] in ("sort", "lm")
    elif kind == "traffic":
        for w in spec["workloads"]:
            assert registry.traffic(w["traffic"])["kind"] in ("sort", "prefill")
    elif kind == "workloads":
        for w in spec["workloads"]:
            assert "limits" in registry.workload(w["name"])["check"]
    else:
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(registry.reader(m["name"]))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(spec):
    for w in spec["workloads"]:
        e2e = [m["name"] for m in registry.metrics_of(spec, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_of(spec, w["name"], True)


def test_reduced_keys_are_no_widths(spec):
    width = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|"
                       r"expansion|experts_per_tok|topk$|d_model|d_ff|d_expert)")
    for c in spec["configs"]:
        for key in c["reduced"]:
            assert not width.search(key), key
            assert key in registry.config(c["name"])["published"]


def test_a_cell_a_config_and_a_metric_added_as_files_only(tmp_path, spec):
    """A later benchmark adds a configuration, a cell and a per-layer
    metric by adding files and entries, with no edit to a file there."""
    root = tmp_path / "checkout"
    shutil.copytree(benchkit.BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    base = registry.config("paper_sort")
    (root / "bench/configs/dummy_sort.json").write_text(json.dumps(
        {**base, "name": "dummy_sort", "keys_per_card": 1 << 12}))
    (root / "bench/traffic/dummy-normal.json").write_text(json.dumps(
        {**registry.traffic("uniform"), "distribution": "normal"}))
    (root / "bench/workloads/dummy_sort-normal.json").write_text(json.dumps(
        {"check": {"sample": 1, "limits": {"keys_mismatched": 0}}}))
    (root / "bench/metrics/dummy.calls.py").write_text(
        "def read(r):\n    return len(r.per_call) or None\n")
    spec["configs"].append({"name": "dummy_sort", "source": "https://example.org/dummy",
                            "file": "bench/configs/dummy_sort.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "dummy_sort-normal", "config": "dummy_sort",
                              "traffic": "dummy-normal", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "sort_keys_per_s":
            m["workloads"].append("dummy_sort-normal")
    spec["per_layer"].append({"name": "dummy.calls", "unit": "count", "better": "higher",
                              "source": "program_span", "layer": "test", "moves":
                              "sort_keys_per_s", "workloads": ["dummy_sort-normal"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _ = benchkit.run_cpu("dummy_sort-normal", trace=True, root=root)
    assert result["correct"] and result["metrics"]["dummy.calls"]["value"] >= 1
    assert set(result["metrics"]) == {"dummy.calls"}
