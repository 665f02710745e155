"""device_idle.prefill: the share of the profiled stretch of prefills
in which no kernel, copy or memset ran on the card (the union of
torch.profiler's device intervals, never their sum), in %."""
from benchlib import readings


def read(r):
    return readings.idle_percent(r)
