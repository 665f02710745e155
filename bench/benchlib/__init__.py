"""The yardstick of the benchmark (``bench/run.py``).

Everything here measures ``repro_torch`` from the outside: the traffic
generators, the statistics, the reading of the profiler's trace, the
table of peaks and the operation counts. None of it imports ``jax``,
``jaxlib`` or ``repro``, and ``reference/`` imports nothing of
``repro_torch`` either (``tests/test_bench_imports.py``).
"""
