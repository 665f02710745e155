"""The model tier of the port: dense GQA decoders, prefill and decode.

What the slice does not run raises NotImplementedError naming the
ROADMAP.md §1 sub-item of item 10 that ports it.
"""
from __future__ import annotations

_LATER = {
    "batching": "item 10.1 (serve/batching.py: per-slot decode positions)",
    "window": "item 10.2 (sliding-window attention and its ring caches)",
    "cross": "item 10.3 (cross-attention, encoder and vision memory)",
    "mla": "item 10.4 (MLA attention)",
    "moe": "item 10.5 (MoE blocks)",
    "recurrent": "item 10.6 (recurrent and SSM mixers)",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md §1, {_LATER[item]})")
