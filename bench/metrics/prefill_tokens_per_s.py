"""prefill_tokens_per_s: every prompt token whose request's first token
came back in the window, over the window's seconds."""
from benchlib import readings


def read(r):
    return readings.window_rate(r)
