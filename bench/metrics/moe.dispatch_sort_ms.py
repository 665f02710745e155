"""moe.dispatch_sort_ms: per prefill, the card's time in the MoE
dispatch's sort (models/moe.py through core/keyenc.stable_argsort and
core/merge.merge_padded_runs_kv): CUDA events around each call, summed
over the prefill's layers; the median over the traced run's prefills."""
import statistics


def read(r):
    per = [c["dispatch_s"] for c in r.per_call if "dispatch_s" in c]
    return statistics.median(per) * 1e3 if per else None
