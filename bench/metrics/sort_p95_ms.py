"""sort_p95_ms: the 95th percentile, over every sort of the window, of
one call's time from its start until its outputs are on the card (CUDA
events on the card's clock); a failed call counts as infinitely long."""
from benchlib import readings


def read(r):
    return readings.tail_ms(r, 95)
