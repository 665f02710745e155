"""Residual block assembly and the layer loop.

The port of ``repro/models/transformer.py`` for the blocks this slice
runs: mixer ``"attn"`` with a dense FFN or none. A block is norm -> mixer
-> norm -> FFN with residual adds. ``repro`` runs each config segment as
one ``lax.scan`` over stacked parameters; here the layers are a list of
per-layer modules in the order ``cfg.layer_list()`` gives, and the scan
is a Python loop over them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import not_ported
from repro_torch.models.layers import MLP, Norm, apply_mlp, apply_norm

_MIXER_ITEMS = {"local_attn": "window", "mla": "mla", "rglru": "recurrent",
                "mamba": "recurrent", "none": "recurrent"}


def check_spec(spec) -> None:
    """Raise NotImplementedError for a block this slice does not run."""
    if spec.mixer != "attn":
        raise not_ported(f"the {spec.mixer!r} mixer", _MIXER_ITEMS[spec.mixer])
    if spec.cross:
        raise not_ported("cross-attention blocks", "cross")
    if spec.ffn == "moe":
        raise not_ported("MoE blocks", "moe")


class Block(nn.Module):
    """``init_block``: ``ln1``, ``mix``, and ``ln2``/``mlp`` for a dense FFN."""

    def __init__(self, spec, cfg, gen, device=None):
        super().__init__()
        check_spec(spec)
        d = cfg.d_model
        self.ln1 = Norm(cfg, d, device)
        self.mix = attn.Attention(cfg, gen, device)
        if spec.ffn == "dense":
            self.ln2 = Norm(cfg, d, device)
            self.mlp = MLP(cfg, d, cfg.d_ff, gen, device)


def init_block_cache(spec, cfg, B: int, S_max: int, device=None) -> dict:
    check_spec(spec)
    return {"mix": attn.init_gqa_cache(cfg, B, S_max, device=device)}


def apply_block(x, p: Block, spec, cfg, *, positions, cache=None, decode=False):
    """Returns (x, new_cache, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = dict(cache) if cache is not None else None

    h = apply_norm(x, p.ln1, cfg)
    out, mc = attn.gqa_forward(
        h, p.mix, cfg, causal=spec.causal, positions=positions,
        rope=cfg.pos_embedding == "rope", cache=cache.get("mix") if cache else None,
        decode=decode,
    )
    x = x + out
    if new_cache is not None and mc is not None:
        new_cache["mix"] = mc

    if spec.ffn == "dense":
        x = x + apply_mlp(apply_norm(x, p.ln2, cfg), p.mlp, cfg)
    return x, new_cache, aux


def run_segments(x, blocks, segments, cfg, *, positions, caches=None, decode=False):
    """Run every layer. ``blocks`` and ``caches`` (or None) hold one entry
    per layer, in segment order: for each (period, count), count copies
    of the period. Returns (x, new_caches, aux_total)."""
    specs = [spec for period, count in segments for _ in range(count) for spec in period]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [] if caches is not None else None
    for i, (spec, p) in enumerate(zip(specs, blocks, strict=True)):
        x, nc, aux = apply_block(x, p, spec, cfg, positions=positions,
                                 cache=caches[i] if caches is not None else None,
                                 decode=decode)
        aux_total = aux_total + aux
        if new_caches is not None:
            new_caches.append(nc)
    return x, new_caches, aux_total
