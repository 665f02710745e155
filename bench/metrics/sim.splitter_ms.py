"""sim.splitter_ms: per sort, the sample-sort steps 2-4 (core/splitters.py,
core/sim.py; on a mesh core/sample_sort.py): the fenced ``splitter`` span of
``SortLimits(trace=True)``; the median over the traced sorts."""
from benchlib import readings


def read(r):
    return readings.phase_ms(r, ("splitter",))
