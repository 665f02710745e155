"""The model tier of the port: GQA, sliding-window, MLA, RG-LRU and Mamba
decoders with dense, MoE or no FFNs, cross-attention over an encoder's
output or vision embeddings, prefill, decode and training, on one device
or (GQA with dense or MoE FFNs) over a mesh.

What the slice does not run raises NotImplementedError naming the
ROADMAP.md §1 item that ports it.
"""
from __future__ import annotations

_LATER = {
    "dryrun": "item 11.4 (launch/dryrun.py and launch/hlo_stats.py)",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md §1, {_LATER[item]})")
