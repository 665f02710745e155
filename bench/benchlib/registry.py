"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the root of the checkout) names the cells, their
configuration and traffic, and the metrics. Each piece is a file of its
own, found by that name:

* ``bench/configs/<config>.json``: the configuration as it is run; its
  ``kind`` names the driver (``benchlib/drivers/<kind>.py``) and its
  ``reference`` the plain reference (``bench/reference/<reference>.py``);
* ``bench/traffic/<traffic>.json``: the traffic mix's parameters;
* ``bench/workloads/<cell>.json``: how the cell's outputs are checked
  (the sample's size and each compared number's limit);
* ``bench/metrics/<metric>.py``: the reader of one metric, ``read(r)``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def use(root: pathlib.Path) -> None:
    """Read the benchmark of another checkout (the tests' copies)."""
    global ROOT, BENCH
    ROOT, BENCH = pathlib.Path(root), pathlib.Path(root) / "bench"


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json: "
                   f"{[w['name'] for w in spec['workloads']]}")


def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def workload(name: str) -> dict:
    return _json("workloads", name)


def driver(kind: str):
    return importlib.import_module(f"benchlib.drivers.{kind}")


def reference(name: str):
    return importlib.import_module(f"reference.{name}")


def reader(metric: str):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader {path} for the metric {metric!r}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: with ``trace`` the per-layer
    ones, else the end-to-end ones. A metric with a ``workloads`` key is
    the listed cells'; a per-layer metric without it is every cell's that
    reports the end-to-end metric it moves; an end-to-end metric without
    it, every cell's."""
    e2e = spec["end_to_end"]
    mine = [m for m in e2e if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return mine
    moved = {m["name"] for m in mine}
    return [m for m in spec["per_layer"]
            if ((cell_name in m["workloads"]) if "workloads" in m else (m["moves"] in moved))]
