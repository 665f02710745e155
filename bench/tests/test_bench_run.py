"""A run end to end on the CPU at a cut size: the last line's schema, the
metrics a run reports, the refusal without a card, and the guard."""
import json
import os
import shutil
import subprocess
import sys

import benchkit
import pytest

from benchlib import harness, registry

CELLS = ["paper_sort-uniform-2p27", "paper_sort-skewed64-argsort-2p27",
         "deepseek-moe-16b-prefill-8k"]


def _schema(result, cell, trace):
    assert list(result)[-1] == "checks" and list(result)[:5] == [
        "correct", "attempted", "failed", "metrics", "device"]
    assert isinstance(result["correct"], bool) and result["attempted"] >= 1
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = {m["name"] for m in registry.metrics_of(registry.benchmark(), cell, trace)}
    assert set(result["metrics"]) <= want
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for v in result["checks"].values():
        assert set(v) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_the_end_to_end_metrics(cell):
    result, err = benchkit.run_cpu(cell)
    _schema(result, cell, False)
    assert result["correct"] and result["failed"] == 0
    e2e = {m["name"] for m in registry.metrics_of(registry.benchmark(), cell, False)}
    assert set(result["metrics"]) == e2e
    # the last lines of standard error: each compared number beside its limit
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[1] for line in last] == list(result["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_per_layer_metrics(cell):
    result, _ = benchkit.run_cpu(cell, trace=True)
    _schema(result, cell, True)
    assert result["correct"]
    # on the CPU no device metric is read: only the spans and counters
    assert not {"kernel_roofline.sort", "prefill_mfu"} & set(result["metrics"])


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, str(benchkit.BENCH / "run.py"), "--workload",
                           CELLS[0], "--seed", str(benchkit.SEED), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=120,
                          cwd=benchkit.ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "{" not in proc.stdout and "refused" in proc.stderr


def test_a_checkout_with_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(benchkit.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(benchkit.ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
                           "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0 and "{" not in proc.stdout


def test_a_process_holding_jax_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    assert "jax" in harness.loaded_forbidden()
    run = harness.Run(CELLS[0], 1, 1.0, False, 0.0, device_type="cpu")
    r = harness.Reading(calls=[{"latency_s": 0.1, "items": 1, "ok": True}], window_s=1.0,
                        setup_s=1.0, compared=1)
    out, err = __import__("io").StringIO(), __import__("io").StringIO()
    assert harness.report(run, r, harness.loaded_forbidden(), out=out, err=err) is None
    assert out.getvalue() == "" and "jax" in err.getvalue()


@pytest.mark.cuda
def test_the_uniform_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
                           str(benchkit.SEED), "--seconds", "3", "--trace", "0"],
                          capture_output=True, text=True, timeout=900, cwd=benchkit.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
