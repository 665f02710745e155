"""imbalance: max/mean of the sort's per-processor counts
(``SortOutput.counts``), the paper's Table II measure, averaged over the
traced sorts (1.0 is perfect balance)."""
from benchlib import readings


def read(r):
    per = [readings.imbalance(c["counts"]) for c in r.per_call if "counts" in c]
    return sum(per) / len(per) if per else None
