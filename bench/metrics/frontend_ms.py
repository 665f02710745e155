"""frontend_ms: per sort, the host's front end (core/api.py,
core/planner.py): the ``plan``, ``encode`` and ``stage`` spans of
``SortLimits(trace=True)``; the median over the traced sorts."""
from benchlib import readings


def read(r):
    return readings.phase_ms(r, ("plan", "encode", "stage"))
