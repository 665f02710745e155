"""Serving: prefill and batched greedy decode with static KV caches.

The port of ``repro/serve/engine.py``. ``make_prefill`` runs the prompt
through the model and returns the last position's logits and the filled
caches; ``extend_caches`` grows them to the generation budget;
``make_serve_step`` decodes one token for the whole batch against the
full-length caches; ``generate`` strings the three together greedily.
The model holds its own parameters, so the functions take no ``params``.
Every entry point runs under ``torch.no_grad()``.

A sharded model (``Model(cfg, axes=...)`` over a mesh) serves through the
same functions, called on every rank with the same global inputs, as
``repro``'s are called with global arrays. Each rank runs its rows of the
batch (``parallel.batch_rows``: the batch axes that divide B) and returns
them, the logits over the whole vocabulary (``parallel.gather_logits``);
its caches are its blocks by ``rules.cache_specs``, and ``seq_shard``
(``repro``'s ``seq_shard_cache``) splits their sequence over "model"
instead of their KV heads. ``generate`` gathers the greedy tokens over the
batch axes after each step, so every rank returns the same (B, n_new).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.model import Model
from repro_torch.sharding import parallel as par


def make_serve_step(model: Model):
    """Decode one token: (caches, tokens (B, 1), pos) -> (logits (B, 1, Vp),
    new_caches). The caches are updated in place. Under a mesh: this
    rank's rows of the logits, from the global tokens."""

    @torch.no_grad()
    def serve_step(caches, tokens, pos):
        rows = par.batch_rows(tokens, model.axes)
        logits, caches, _ = model({"tokens": rows}, caches=caches, decode=True, pos=pos)
        return par.gather_logits(logits, model.axes), caches

    return serve_step


def make_prefill(model: Model):
    """Run the prompt through the model, returning last-position logits and
    the populated caches (length = prompt length; the cross caches as long
    as the memory: ``frames`` or ``vision``, axis 1). Under a mesh: this
    rank's rows and cache blocks, ``prefill(batch, seq_shard=True)`` the
    caches' sequence over "model" (module docstring)."""

    @torch.no_grad()
    def prefill(batch, seq_shard: bool = False):
        B, S = batch["tokens"].shape
        memory_len = 0
        if model.cfg.encoder_segments:
            memory_len = batch["frames"].shape[1]
        elif model.cfg.n_vision_tokens:
            memory_len = batch["vision"].shape[1]
        caches = model.init_caches(B, S, memory_len=memory_len, device=batch["tokens"].device,
                                   seq_shard=seq_shard)
        rows = {k: par.batch_rows(v, model.axes) for k, v in batch.items()}
        logits, caches, _ = model(rows, caches=caches)
        # a copy: frees the (B, S, Vp) logits
        return par.gather_logits(logits[:, -1:].contiguous(), model.axes).clone(), caches

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


def _whole_seq(model: Model, mix: dict) -> dict:
    """The tensors of a ``seq_shard`` cache with their positions (axis 1)
    gathered whole where its ``seq_len`` divides over "model" (collective);
    ``pos`` and ``seq_len`` left out."""
    axes = model.axes
    split = mix["seq_len"] % axes.model_size == 0
    return {name: par.gather(t, 1, axes, axes.model) if split else t
            for name, t in mix.items() if name not in ("pos", "seq_len")}


def _cut_seq(model: Model, mix: dict, S: int) -> dict:
    """A whole cache of S positions as a ``seq_shard`` one: each tensor's
    block of them where S divides over "model", else whole."""
    axes = model.axes
    split = S % axes.model_size == 0
    return {**{name: par.shard_leaf(t, (None, axes.model), axes).clone() if split else t
               for name, t in mix.items()}, "seq_len": S}


def _grow_seq_shard(model: Model, mix: dict, S_max: int) -> dict:
    """A ``seq_shard`` cache (every KV head, or MLA's compressed entries;
    the positions over "model" when its ``seq_len`` divides there) grown
    to S_max: rank r holds the r-th block of S_max, so positions move
    between the ranks. Gathered whole, padded, and cut again
    (collective)."""
    whole = _whole_seq(model, mix)
    return _cut_seq(model, {name: F.pad(t, (0, 0) * (t.dim() - 2) + (0, S_max - t.shape[1]))
                            for name, t in whole.items()}, S_max)


def _grow_seq_ring(model: Model, mix: dict, prefill_len: int, S_max: int) -> dict:
    """A ``seq_shard`` ring (its W slots over "model" when it divides W)
    grown as ``_grow_ring`` grows a whole one: gathered, re-slotted or
    rolled, and cut again (collective)."""
    ring = _grow_ring({**_whole_seq(model, mix), "pos": mix["pos"]},
                      model.cfg.sliding_window, prefill_len, S_max)
    pos = ring.pop("pos")
    return {**_cut_seq(model, ring, pos.shape[0]), "pos": pos}


@torch.no_grad()
def extend_caches(model: Model, caches, prefill_len: int, S_max: int):
    """Grow the caches from prefill length to the decode budget: zero-pad
    the sequence axis, axis 1, of each layer's full-attention (B, S, KV,
    dh) buffers and of its MLA (B, S, kv_lora_rank) and (B, S, qk_rope_dim)
    compressed ones (``repro`` pads axis 2 of its stacked ones); re-slot or
    roll each sliding-window ring (``_grow_ring``); pass the recurrent
    caches (conv and h) and the cross caches (ck and cv), fixed size,
    through unchanged. A ``seq_shard`` cache of a sharded model moves
    between its ranks (``_grow_seq_shard``, ``_grow_seq_ring``); the other
    caches of a sharded model grow where they are."""
    out = []
    for c in caches:
        mix = c.get("mix")
        if mix is None or "conv" in mix:
            out.append(c)
            continue
        if "pos" in mix and "seq_len" in mix:
            mix = _grow_seq_ring(model, mix, prefill_len, S_max)
        elif "seq_len" in mix:
            mix = _grow_seq_shard(model, mix, S_max)
        elif "pos" in mix:
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
def generate(model: Model, batch, n_new: int, seq_shard: bool = False):
    """Greedy batched generation: (B, n_new) int32 tokens. ``batch`` holds
    the prompts' ``tokens`` and, for a model with memory, its ``frames`` or
    ``vision``, which the prefill reads. Under a mesh every rank passes the
    same global batch and returns the same tokens (module docstring)."""
    prefill = make_prefill(model)
    step = make_serve_step(model)
    B, S = batch["tokens"].shape
    vocab = model.cfg.vocab

    def greedy(logits):  # every rank's rows of the next tokens
        return par.gather_batch(logits[..., :vocab].argmax(-1).to(torch.int32), model.axes, B)

    logits, caches = prefill(batch, seq_shard)
    caches = extend_caches(model, caches, S, S + n_new)
    tok = greedy(logits)
    outs = [tok]
    for i in range(n_new - 1):
        logits, caches = step(caches, tok, S + i)
        tok = greedy(logits)
        outs.append(tok)
    return torch.cat(outs, dim=1)
