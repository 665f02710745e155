"""overflow_retries: the overflow ladder's retries (``SortOutput.meta.retries``,
core/overflow.py) summed over the traced sorts, over their number."""


def read(r):
    per = [c["retries"] for c in r.per_call if "retries" in c]
    return sum(per) / len(per) if per else None
