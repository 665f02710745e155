"""The model tier of the port: GQA, sliding-window, MLA, RG-LRU and Mamba
decoders with dense, MoE or no FFNs, cross-attention over an encoder's
output or vision embeddings, prefill, decode and training.

What the slice does not run raises NotImplementedError naming the
ROADMAP.md §1 item that ports it.
"""
from __future__ import annotations

_LATER = {
    "moe_ep": "item 11.3 (with item 10.4.1, EP x TP MoE decode: cfg.decode_moe_ep, "
              "tp_axis)",
    "tp_mixers": "item 11.2 (tensor parallelism for MLA, RG-LRU, Mamba, sliding windows, "
                 "cross-attention and the encoder, and sharded Adafactor)",
    "sharded_serve": "item 11.3 (sharded prefill and decode over rules.cache_specs, with "
                     "item 10.4.1)",
    "dryrun": "item 11.4 (launch/dryrun.py and launch/hlo_stats.py)",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md §1, {_LATER[item]})")
