"""A run of a cell of several ranks on the CPU (gloo), for the tests:

    python rank_cpu.py --root <checkout> [--fault <name>] [--hold <module>] <run arguments>

reads the benchmark of ``<checkout>``. Without ``--rank`` in the run's
arguments it is rank 0: it starts the other ranks as this script with the
same options and prints the result line. With a fault, the program is
broken underneath first in every rank (``faults.py``); with ``--hold``,
ranks 1.. load a module of that name, as a rank that loaded JAX would.
"""
import pathlib
import sys
import time
import types

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src"), str(BENCH / "tests")]

from benchlib import harness, registry  # noqa: E402


def main(argv) -> int:
    t_start = time.perf_counter()
    own = []
    while argv[:1] and argv[0] in ("--root", "--fault", "--hold"):
        own += argv[:2]
        argv = argv[2:]
    opts = dict(zip(own[::2], own[1::2]))
    registry.use(pathlib.Path(opts["--root"]))
    if "--fault" in opts:
        import faults

        faults.apply(opts["--fault"])
    if "--rank" in argv:
        if "--hold" in opts:
            sys.modules[opts["--hold"]] = types.ModuleType(opts["--hold"])
        return harness.rank_entry(argv, device_type="cpu")
    a = harness.parse(argv)
    result = harness.execute(a.workload, a.seed, a.seconds, bool(a.trace), t_start,
                             device_type="cpu",
                             rank_command=[sys.executable, __file__] + own)
    return 0 if result is not None else 3


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
