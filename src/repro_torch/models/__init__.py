"""The model tier of the port: GQA and MLA decoders with dense or MoE FFNs,
prefill, decode and training.

What the slice does not run raises NotImplementedError naming the
ROADMAP.md §1 item that ports it.
"""
from __future__ import annotations

_LATER = {
    "window": "item 10.2 (sliding-window attention and its ring caches)",
    "cross": "item 10.3 (cross-attention, encoder and vision memory)",
    "moe_ep": "item 10.4.1 (EP x TP MoE decode: cfg.decode_moe_ep, tp_axis), under "
              "item 11: it needs the sharded model tier",
    "recurrent": "item 10.6 (recurrent and SSM mixers)",
    "sharded_train": "item 11 (sharded parameters and optimizer states through "
                     "sharding/rules.py)",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md §1, {_LATER[item]})")
