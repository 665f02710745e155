"""The model tier of the port: GQA, sliding-window, MLA, RG-LRU and Mamba
decoders with dense, MoE or no FFNs, cross-attention over an encoder's
output or vision embeddings, prefill, decode and training.

What the slice does not run raises NotImplementedError naming the
ROADMAP.md §1 item that ports it.
"""
from __future__ import annotations

_LATER = {
    "moe_ep": "item 10.4.1 (EP x TP MoE decode: cfg.decode_moe_ep, tp_axis), under "
              "item 11: it needs the sharded model tier",
    "sharded_train": "item 11 (sharded parameters and optimizer states through "
                     "sharding/rules.py)",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md §1, {_LATER[item]})")
