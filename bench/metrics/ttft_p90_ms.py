"""ttft_p90_ms: the 90th percentile, over every request of the window, of
the time from its issue to its first token on the host (the host's
clock); a failed request counts as infinitely long."""
from benchlib import readings


def read(r):
    return readings.tail_ms(r, 90)
