"""Residual block assembly and the layer loop.

The port of ``repro/models/transformer.py``: mixer ``"attn"`` (GQA),
``"local_attn"`` (GQA over a sliding window of cfg.sliding_window keys,
rope always on), ``"mla"`` (deepseek-v3's latent attention), ``"rglru"``
or ``"mamba"`` (``recurrent.py``) or ``"none"`` (adds zeros), an optional
cross-attention mixer (``spec.cross``: whisper's decoder, the VLM's
image layers) over the model's memory, and a dense FFN, an MoE FFN (plus
its shared experts) or none. A block is norm -> mixer -> (norm ->
cross-attention) -> norm -> FFN with residual adds. ``repro`` runs each
config segment as one ``lax.scan`` over stacked parameters; here the
layers are a list of per-layer modules in the order ``cfg.layer_list()``
gives (the encoder's in ``cfg.encoder_segments`` order), and the scan is
a Python loop over them.

An MoE block runs the sorted dispatch (``moe.moe_forward``) at prefill
and the per-token expert gather (``moe.moe_forward_decode``) at decode,
or, with ``cfg.decode_moe_ep`` on a mesh whose experts lie over ("data",
"model"), ``repro``'s EP x TP decode: the sorted dispatch over "data"
with d_expert over "model" (``moe_forward(..., tp_axis=)``).
``apply_block``'s ``use_pallas_moe`` picks the dispatch sort's path; it
mirrors ``repro``'s signature, and nothing in the port's model passes it
(``run_segments`` takes the default). Its default here is True, so that
on the card the model's dispatch launches the bitonic kernels, where
``repro``'s is False (``lax.sort``); both give the same bits.

Under a mesh (``axes`` with a ``DeviceMesh``) a block runs
tensor-parallel over "model": every mixer (``attention.gqa_forward`` with
or without a window, ``attention.mla_forward``, ``recurrent.rglru_forward``,
``recurrent.mamba_forward``), the cross-attention mixer, and
``layers.apply_mlp`` for the dense FFN and the shared experts. Training
and prefill run the MoE token-parallel: each rank of "model" routes its
slice of the sequence (``split_seq``) to the experts over the expert axes
and gathers the outputs (``gather_seq``); decode runs it over the decode
layout of the experts (``rules.param_specs(mode="decode")``, which
``Model`` puts in place).
"""
from __future__ import annotations

import dataclasses
import types

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import MLP, Norm, apply_mlp, apply_norm, torch_dtype
from repro_torch.sharding import parallel as par


def segment_specs(segments) -> list:
    """The block specs of ``segments`` ((period, count), ...) in layer order."""
    return [spec for period, count in segments for _ in range(count) for spec in period]


def _window(spec, cfg) -> int:
    return cfg.sliding_window if spec.mixer == "local_attn" else 0


class Block(nn.Module):
    """``init_block``: ``ln1``, ``mix`` (``attn.Attention``, ``attn.MLA``,
    ``recurrent.RGLRU``, ``recurrent.Mamba``, or None for mixer "none"),
    and ``ln2`` with ``mlp`` for a dense FFN or with ``moe`` (and
    ``shared``, an MLP of width d_expert x n_shared_experts, when
    cfg.n_shared_experts) for an MoE FFN; ``ln_x`` and ``cross`` (a cross
    ``attn.Attention``) for a spec with ``cross``. ``axes`` pads the
    attention heads (``Axes.pad_heads``) and goes to every mixer."""

    def __init__(self, spec, cfg, gen, device=None, axes=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = Norm(cfg, d, device)
        mixers = {"attn": attn.Attention, "local_attn": attn.Attention, "mla": attn.MLA,
                  "rglru": rec.RGLRU, "mamba": rec.Mamba}
        self.mix = mixers[spec.mixer](cfg, gen, device, axes=axes) if spec.mixer in mixers else None
        if spec.cross:
            self.ln_x = Norm(cfg, d, device)
            self.cross = attn.Attention(cfg, gen, device, cross=True, axes=axes)
        if spec.ffn == "dense":
            self.ln2 = Norm(cfg, d, device)
            self.mlp = MLP(cfg, d, cfg.d_ff, gen, device)
        elif spec.ffn == "moe":
            self.ln2 = Norm(cfg, d, device)
            self.moe = moe_lib.init_moe(cfg, gen, device)
            self.shared = (MLP(cfg, d, cfg.d_expert * cfg.n_shared_experts, gen, device)
                           if cfg.n_shared_experts else None)


def init_block_cache(spec, cfg, B: int, S_max: int, device=None, memory_len: int = 0) -> dict:
    """The mixer's zeroed cache as ``"mix"`` (none for mixer "none"), and
    for a cross block the ``"cross"`` cache: ``ck``/``cv`` of zeros, (B,
    memory_len, KV, dh) each, which prefill replaces."""
    c = {}
    if spec.mixer == "mla":
        c["mix"] = attn.init_mla_cache(cfg, B, S_max, device=device)
    elif spec.mixer == "rglru":
        c["mix"] = rec.init_rglru_cache(cfg, B, device=device)
    elif spec.mixer == "mamba":
        c["mix"] = rec.init_mamba_cache(cfg, B, device=device)
    elif spec.mixer != "none":
        c["mix"] = attn.init_gqa_cache(cfg, B, S_max, window=_window(spec, cfg), device=device)
    if spec.cross:
        shape = (B, memory_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross"] = {name: torch.zeros(shape, dtype=torch_dtype(cfg.dtype), device=device)
                      for name in ("ck", "cv")}
    return c


def _moe_sharded(h, p: Block, cfg, axes, use_pallas: bool):
    """The token-parallel MoE of a sharded block: this rank's slice of the
    sequence over "model" through its experts (module docstring)."""
    if par.group(axes, axes.model) is not None and h.shape[1] % axes.model_size:
        raise ValueError(f"a sequence of {h.shape[1]} does not split over "
                         f"{axes.model_size} ranks of {axes.model!r}")
    local = types.SimpleNamespace(router=par.copy_to(p.moe.router, axes), wi=p.moe.wi,
                                  wg=p.moe.wg, wo=p.moe.wo)
    mo, a = moe_lib.moe_forward(par.split_seq(h, axes), local, cfg, axes, use_pallas=use_pallas)
    return par.gather_seq(mo, axes), a


def apply_block(x, p: Block, spec, cfg, *, positions, cache=None, decode=False, memory=None,
                use_pallas_moe: bool = True, axes=None):
    """Returns (x, new_cache, aux). A cross block attends to ``memory``
    (B, M, d) outside decode, and to its ``"cross"`` cache in decode.
    ``axes`` with a mesh: this rank's part of the block (module
    docstring)."""
    sharded = axes is not None and axes.mesh is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = dict(cache) if cache is not None else None

    h = apply_norm(x, p.ln1, cfg)
    mix_cache = cache.get("mix") if cache else None
    if spec.mixer in ("attn", "local_attn"):
        out, mc = attn.gqa_forward(
            h, p.mix, cfg, causal=spec.causal, window=_window(spec, cfg), positions=positions,
            rope=cfg.pos_embedding == "rope" or spec.mixer == "local_attn",
            cache=mix_cache, decode=decode, axes=axes,
        )
    elif spec.mixer == "mla":
        out, mc = attn.mla_forward(h, p.mix, cfg, positions=positions, cache=mix_cache,
                                   decode=decode, axes=axes)
    elif spec.mixer == "rglru":
        out, mc = rec.rglru_forward(h, p.mix, cfg, cache=mix_cache, decode=decode, axes=axes)
    elif spec.mixer == "mamba":
        out, mc = rec.mamba_forward(h, p.mix, cfg, cache=mix_cache, decode=decode, axes=axes)
    else:  # "none"
        out, mc = torch.zeros_like(x), mix_cache
    x = x + out
    if new_cache is not None and mc is not None:
        new_cache["mix"] = mc

    if spec.cross:
        out, cc = attn.gqa_forward(apply_norm(x, p.ln_x, cfg), p.cross, cfg, causal=False,
                                   positions=positions, cache=cache.get("cross") if cache else None,
                                   memory=memory, axes=axes)
        x = x + out
        if new_cache is not None and cc is not None:
            new_cache["cross"] = cc

    if spec.ffn == "dense":
        x = x + apply_mlp(apply_norm(x, p.ln2, cfg), p.mlp, cfg, axes)
    elif spec.ffn == "moe":
        h = apply_norm(x, p.ln2, cfg)
        if decode:
            if cfg.decode_moe_ep and sharded and tuple(axes.expert) == ("data", "model"):
                # EP(data) x TP(model), repro's DESIGN.md §5
                mo, a = moe_lib.moe_forward(h, p.moe, cfg,
                                            dataclasses.replace(axes, expert=("data",)),
                                            tp_axis=axes.model, use_pallas=use_pallas_moe)
            else:
                mo, a = moe_lib.moe_forward_decode(h, p.moe, cfg, axes)
        elif sharded:
            mo, a = _moe_sharded(h, p, cfg, axes, use_pallas_moe)
        else:
            mo, a = moe_lib.moe_forward(h, p.moe, cfg, use_pallas=use_pallas_moe)
        aux = aux + a
        if p.shared is not None:
            mo = mo + apply_mlp(h, p.shared, cfg, axes)
        x = x + mo
    return x, new_cache, aux


def run_segments(x, blocks, segments, cfg, *, positions, caches=None, decode=False,
                 memory=None, axes=None):
    """Run every layer. ``blocks`` and ``caches`` (or None) hold one entry
    per layer, in segment order: for each (period, count), count copies
    of the period. ``memory`` goes to every block (the cross blocks read
    it). Returns (x, new_caches, aux_total).

    With cfg.remat, outside decode and while autograd records, each block
    is rematerialized (``torch.utils.checkpoint``, non-reentrant): its
    activations are dropped after the forward and the backward runs the
    block again, MoE dispatch and sort included, as ``repro`` wraps each
    segment period in ``jax.checkpoint``."""
    specs = segment_specs(segments)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [] if caches is not None else None
    remat = cfg.remat and not decode and torch.is_grad_enabled()
    for i, (spec, p) in enumerate(zip(specs, blocks, strict=True)):
        cache = caches[i] if caches is not None else None
        if remat:
            x, nc, aux = checkpoint(apply_block, x, p, spec, cfg, positions=positions,
                                    cache=cache, memory=memory, axes=axes,
                                    use_reentrant=False)
        else:
            x, nc, aux = apply_block(x, p, spec, cfg, positions=positions, cache=cache,
                                     decode=decode, memory=memory, axes=axes)
        aux_total = aux_total + aux
        if new_caches is not None:
            new_caches.append(nc)
    return x, new_caches, aux_total
