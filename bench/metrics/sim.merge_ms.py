"""sim.merge_ms: per sort, the merge step (core/merge.py,
kernels/ops.py::_scatter_merge): the fenced ``merge`` span of
``SortLimits(trace=True)``; the median over the traced sorts."""
from benchlib import readings


def read(r):
    return readings.phase_ms(r, ("merge",))
