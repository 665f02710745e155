"""What the benchmark's tests share: the paths, a checkout of the
benchmark cut to sizes at which its cells run on the CPU, and a run of a
cell on the CPU that skips the harness's look for a card and returns its
result line."""
from __future__ import annotations

import atexit
import contextlib
import functools
import io
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src"), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2**31 + 4242  # past 32 signed bits, as the driver's seeds are

# the cut checkout's files: each merged over the file of that name
CUT = {
    "configs/paper_sort": {"keys_per_card": 1 << 13},
    "configs/deepseek-moe-16b": {
        "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_head": 16, "d_ff": 128,
        "vocab": 512, "n_experts": 8, "moe_topk": 2, "n_shared_experts": 1, "d_expert": 32,
        "layers": [{"mixer": "attn", "ffn": "dense", "count": 1},
                   {"mixer": "attn", "ffn": "moe", "count": 2}]},
    "traffic/uniform": {"profile_calls": 2},
    "traffic/skewed64-argsort": {"profile_calls": 2},
    "traffic/mesh4-uniform": {"profile_calls": 2},
    "traffic/prefill-8k": {"prompt_tokens": 64, "pool": 2, "profile_calls": 2},
    "workloads/deepseek-moe-16b-prefill-8k": {
        "check": {"sample": 2, "limits": {"logit_err": 0.05, "token_gap": 0.1}}},
}
# a cell of four ranks, which the tests add to the cut checkout's
# BENCHMARK.json from the data files that the benchmark keeps for it
MESH = {"name": "paper_sort-mesh4-uniform-2p27", "config": "paper_sort",
        "traffic": "mesh4-uniform", "chips": 4,
        "why": "four ranks, one a card, each its shard of uniform keys"}
RANK_CPU = [sys.executable, str(BENCH / "tests" / "rank_cpu.py")]


@functools.lru_cache(maxsize=None)
def cut_root() -> pathlib.Path:
    """A checkout of the benchmark at the cut sizes, made once a process
    (removed at its exit)."""
    root = pathlib.Path(tempfile.mkdtemp(prefix="bench-cut-"))
    atexit.register(shutil.rmtree, root, True)
    for kind in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / kind, root / "bench" / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, cut in CUT.items():
        path = root / "bench" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **cut}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append(MESH)
    for m in spec["end_to_end"]:
        if m["name"] in ("sort_keys_per_s", "sort_p95_ms"):
            m["workloads"].append(MESH["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@contextlib.contextmanager
def reading(root: pathlib.Path | None = None):
    """Within it the registry reads the checkout at ``root`` (the cut one
    by default)."""
    from benchlib import registry

    old = registry.ROOT
    registry.use(root or cut_root())
    try:
        yield registry
    finally:
        registry.use(old)


def pieces(cell: str, root: pathlib.Path | None = None) -> tuple:
    """(config, traffic, workload) of a cell of the checkout at ``root``."""
    with reading(root) as registry:
        spec = registry.cell(registry.benchmark(), cell)
        return (registry.config(spec["config"]), registry.traffic(spec["traffic"]),
                registry.workload(cell))


def run_cpu(cell: str, *, trace: bool = False, seconds: float = 0.5, seed: int = SEED,
            root: pathlib.Path | None = None, rank_args: tuple = ()):
    """(result, standard error) of one run of ``cell`` on the CPU, read
    from the checkout at ``root`` (the cut one by default). A cell of one
    rank runs in this process; the test process may hold JAX already (the
    repository's other tests load it), so the guard here refuses only what
    the run itself loads. A cell of several ranks runs every rank in a
    process of its own (``rank_cpu.py``, given ``rank_args``), as the
    benchmark does, and none of them may hold JAX."""
    from benchlib import harness

    root = root or cut_root()
    with reading(root) as registry:
        ranks = registry.traffic(registry.cell(registry.benchmark(), cell)["traffic"])
        ranks = int(ranks.get("ranks", 1))
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace",
            str(int(trace))]
    if ranks > 1:
        proc = subprocess.run(RANK_CPU + ["--root", str(root), *rank_args] + argv,
                              capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
        return result, proc.stderr
    held = set(harness.loaded_forbidden())
    guard = harness.loaded_forbidden
    harness.loaded_forbidden = lambda: sorted(set(guard()) - held)
    out, err = io.StringIO(), io.StringIO()
    try:
        with reading(root):
            result = harness.execute(cell, seed, seconds, trace, time.perf_counter(),
                                     device_type="cpu", out=out, err=err)
    finally:
        harness.loaded_forbidden = guard
    assert result is not None, err.getvalue()[-2000:]
    last = out.getvalue().strip().splitlines()[-1]
    assert json.loads(last) == result
    return result, err.getvalue()
