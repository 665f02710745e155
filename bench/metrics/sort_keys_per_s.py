"""sort_keys_per_s: every key of every sort completed in the window
(on several ranks, every rank's), over the window's seconds."""
from benchlib import readings


def read(r):
    return readings.window_rate(r)
