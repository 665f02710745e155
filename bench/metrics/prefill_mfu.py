"""prefill_mfu: the model FLOPs of the prefills completed before the
profiled stretch (``counts.lm_prefill_flops``, from the configuration's
published widths, not the program's own count) over that stretch's
seconds times the card's bf16 peak, in %."""
from benchlib import counts


def read(r):
    peak = counts.PEAKS.get(r.device_kind)
    seconds, n = r.extra.get("mfu_window_s"), r.extra.get("mfu_requests")
    if peak is None or not seconds or not n:
        return None
    ok = sum(1 for c in r.calls[:n] if c["ok"])
    return 100.0 * ok * r.extra["flops_per_request"] / (seconds * peak["bf16_flops"])
