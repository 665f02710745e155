"""Serving: prefill and batched greedy decode with static KV caches.

The port of ``repro/serve/engine.py``. ``make_prefill`` runs the prompt
through the model and returns the last position's logits and the filled
caches; ``extend_caches`` grows them to the generation budget;
``make_serve_step`` decodes one token for the whole batch against the
full-length caches; ``generate`` strings the three together greedily.
The model holds its own parameters, so the functions take no ``params``.
Every entry point runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.model import Model


def make_serve_step(model: Model):
    """Decode one token: (caches, tokens (B, 1), pos) -> (logits (B, 1, Vp),
    new_caches). The caches are updated in place."""

    @torch.no_grad()
    def serve_step(caches, tokens, pos):
        logits, caches, _ = model({"tokens": tokens}, caches=caches, decode=True, pos=pos)
        return logits, caches

    return serve_step


def make_prefill(model: Model):
    """Run the prompt through the model, returning last-position logits and
    the populated caches (length = prompt length; the cross caches as long
    as the memory: ``frames`` or ``vision``, axis 1)."""

    @torch.no_grad()
    def prefill(batch):
        B, S = batch["tokens"].shape
        memory_len = 0
        if model.cfg.encoder_segments:
            memory_len = batch["frames"].shape[1]
        elif model.cfg.n_vision_tokens:
            memory_len = batch["vision"].shape[1]
        caches = model.init_caches(B, S, memory_len=memory_len, device=batch["tokens"].device)
        logits, caches, _ = model(batch, caches=caches)
        return logits[:, -1:].clone(), caches  # a copy: frees the (B, S, Vp) logits

    return prefill


def _grow_ring(mix: dict, window: int, prefill_len: int, S_max: int) -> dict:
    """A ring cache (k/v (B, W, KV, dh), pos (W,)) as decode reads it: the
    entry of position p at slot p % W2, W2 = min(window, S_max). When W2 >
    W (the prompt was shorter than the window) each entry moves to its
    slot of a new ring of W2, whose other slots are empty (pos -1);
    otherwise prefill's last W entries, held densely, roll by prefill_len
    % W."""
    k, v, pos = mix["k"], mix["v"], mix["pos"]
    W = k.shape[1]
    W2 = min(window, S_max) if window else W
    if W2 <= W:
        shift = prefill_len % W
        return {"k": torch.roll(k, shift, 1), "v": torch.roll(v, shift, 1),
                "pos": torch.roll(pos, shift, 0)}
    slots = torch.where(pos >= 0, pos.long() % W2, W2)  # slot W2 takes what is dropped
    out = {}
    for name, t in (("k", k), ("v", v)):
        z = t.new_zeros(t.shape[:1] + (W2 + 1,) + t.shape[2:])
        z[:, slots] = t
        out[name] = z[:, :W2]
    zp = pos.new_full((W2 + 1,), -1)
    zp[slots] = pos
    out["pos"] = zp[:W2]
    return out


@torch.no_grad()
def extend_caches(model: Model, caches, prefill_len: int, S_max: int):
    """Grow the caches from prefill length to the decode budget: zero-pad
    the sequence axis, axis 1, of each layer's full-attention (B, S, KV,
    dh) buffers and of its MLA (B, S, kv_lora_rank) and (B, S, qk_rope_dim)
    compressed ones (``repro`` pads axis 2 of its stacked ones); re-slot or
    roll each sliding-window ring (``_grow_ring``); pass the recurrent
    caches (conv and h) and the cross caches (ck and cv), fixed size,
    through unchanged."""
    out = []
    for c in caches:
        mix = c.get("mix")
        if mix is None or "conv" in mix:
            out.append(c)
            continue
        if "pos" in mix:
            mix = _grow_ring(mix, model.cfg.sliding_window, prefill_len, S_max)
        else:
            pad = S_max - next(iter(mix.values())).shape[1]
            if pad > 0:  # pad the sequence axis (1) only
                mix = {name: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for name, t in mix.items()}
        out.append({**c, "mix": mix})
    return out


@torch.no_grad()
def sample_logits(logits, generator: torch.Generator | None = None, *, top_k: int = 0,
                  temperature: float = 1.0, real_vocab: int | None = None):
    """Top-k / temperature sampling over (B, 1, Vp) logits (pads masked);
    greedy when temperature <= 0. Returns (B, 1) int32."""
    lf = logits[:, 0].float()
    if real_vocab is not None:
        cols = torch.arange(lf.shape[-1], device=lf.device)
        lf = torch.where(cols < real_vocab, lf, -1e30)
    if temperature <= 0:
        return lf.argmax(-1).to(torch.int32)[:, None]
    lf = lf / temperature
    if top_k:
        v, idx = torch.topk(lf, top_k)
        draw = torch.multinomial(torch.softmax(v, -1), 1, generator=generator)
        tok = torch.gather(idx, 1, draw)[:, 0]
    else:
        tok = torch.multinomial(torch.softmax(lf, -1), 1, generator=generator)[:, 0]
    return tok.to(torch.int32)[:, None]


@torch.no_grad()
def generate(model: Model, batch, n_new: int):
    """Greedy batched generation: (B, n_new) int32 tokens. ``batch`` holds
    the prompts' ``tokens`` and, for a model with memory, its ``frames`` or
    ``vision``, which the prefill reads."""
    prefill = make_prefill(model)
    step = make_serve_step(model)
    B, S = batch["tokens"].shape
    vocab = model.cfg.vocab
    logits, caches = prefill(batch)
    caches = extend_caches(model, caches, S, S + n_new)
    tok = logits[..., :vocab].argmax(-1).to(torch.int32)
    outs = [tok]
    for i in range(n_new - 1):
        logits, caches = step(caches, tok, S + i)
        tok = logits[..., :vocab].argmax(-1).to(torch.int32)
        outs.append(tok)
    return torch.cat(outs, dim=1)
