#!/usr/bin/env python3
"""The benchmark of repro_torch, one cell a run.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for (``BENCHMARK.json``). The last line of standard output is the
result, one JSON object; the last lines of standard error are the
numbers compared against their limits. See ``bench/README.md``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
# every build and kernel cache at a fixed path inside the checkout (the
# port's own nvcc builds go to build/ there, by kernels/build.py)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")

from benchlib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
