"""Config -> model: parameters, the forward pass for prefill and decode.

The port of ``repro/models/model.py`` for every config: GQA,
sliding-window, MLA, RG-LRU and Mamba blocks with dense, MoE or no FFNs,
cross-attention blocks, and whisper's encoder. ``repro``'s ``Model`` is a
frozen description plus a parameter pytree; here it is an ``nn.Module``
that holds its parameters, drawn from a seeded ``torch.Generator`` on its
device, or loaded from ``repro``'s with ``convert.params_from_jax``.

Batch dict keys:
  tokens  (B, S) integer        — the decoder's input
  labels  (B, S) integer        — next-token targets (training)
  frames  (B, S_enc, d)         — whisper's stub frame embeddings
  vision  (B, n_vision_tokens, d) — the VLM's stub patch embeddings

The memory the cross blocks attend to (``_memory``) is the encoder's
output over the frames plus their sinusoidal embedding (non-causal, no
rope, then the encoder's final norm), or the vision embeddings as they
are; it is computed outside decode only, where the cross caches hold its
projections. Frames and vision enter in the model's dtype (cast if
given in another): ``repro`` would promote a float32 memory through a
bfloat16 model, which PyTorch's matmuls refuse.

``Model(cfg, axes=...)`` is ``repro``'s ``Model(cfg, axes)``: the heads
and the vocabulary padded to the model axis. With a mesh in ``axes``
(``spec.from_mesh``) it is this rank's part of the sharded model: each
parameter is this rank's block, by ``rules.param_specs`` (``specs``), of
the leaf the one-rank model draws from the same seed. A rank draws one
whole leaf at a time, in the one-rank model's order, and keeps its block,
so it never holds the whole model. The forward takes the rank's block of
the batch and returns logits over its block of the padded vocabulary
(``train/loss.py`` takes them so). With ``axes`` and no mesh the model
holds the whole padded leaves: their shapes on the meta device are
``repro``'s ``abstract_params(cfg, axes=axes)``.

A sharded model also serves (``serve/engine.py``). Its caches are each
rank's blocks by ``rules.cache_specs`` (``init_caches``), and prefill and
decode return the rank's rows of ``repro``'s outputs. ``repro`` lowers
prefill with the train layout of the experts and decode with
``param_specs(mode="decode")`` (d_expert over "model"; with
``cfg.decode_moe_ep`` on 2-D experts, experts over "data" too): the model
holds one layout at a time, and ``forward`` re-lays the experts leaf by
leaf when it switches between decode and the rest
(``parallel.relay_leaf``: one all-to-all over "model", and a gather over
"data" where the decode layout drops it), so that no rank ever holds
more than its block and one leaf's pieces in flight. ``specs`` is the
layout it holds.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    Embed, Norm, _init, apply_norm, draw, embed_tokens, recording, sinusoidal_embed,
    torch_dtype,
)
from repro_torch.sharding import parallel as par
from repro_torch.sharding import rules
from repro_torch.sharding.spec import Axes, vocab_pad


class LMHead(nn.Module):
    """The untied output projection ``w`` (d_model, vocab_padded)."""

    def __init__(self, cfg, vocab_padded: int, gen, device=None):
        super().__init__()
        self.w = _init(gen, (cfg.d_model, vocab_padded), cfg.d_model ** -0.5,
                       torch_dtype(cfg.dtype), device)


class Encoder(nn.Module):
    """``params["encoder"]``: one block a layer of ``cfg.encoder_segments``
    (``layers``) and ``final_norm``."""

    def __init__(self, cfg, gen, device=None, axes=None):
        super().__init__()
        self.layers = nn.ModuleList(tfm.Block(spec, cfg, gen, device, axes=axes)
                                    for spec in tfm.segment_specs(cfg.encoder_segments))
        self.final_norm = Norm(cfg, cfg.d_model, device)


class Model(nn.Module):
    """A model on ``device`` (None means "cuda"; "meta" builds shapes
    only, for ``ModelConfig.param_count``) with weights drawn from
    ``seed``; with ``encoder``, an ``Encoder``, when cfg.encoder_segments.
    ``cfg`` is read at every forward. ``axes``: module docstring; under a
    mesh, ``specs`` maps each parameter to its spec and ``global_shapes``
    to its whole shape."""

    def __init__(self, cfg: ModelConfig, *, axes: Axes | None = None, device=None,
                 seed: int = 0):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else resolve(device)
        self.cfg = cfg
        self.axes = axes
        self.specs = None
        self.layout = "train"
        if not self.sharded or dev.type == "meta":
            gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
            self._build(gen, dev)
            return
        par.make_groups(axes)
        with recording() as drawn:
            self._build(None, torch.device("meta"))
        names = {id(p): n for n, p in self.named_parameters()}
        self.global_shapes = {n: tuple(p.shape) for n, p in self.named_parameters()}
        self.specs = rules.param_specs(self.global_shapes, cfg, axes)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for p, kind, arg in drawn:  # the one-rank model's order
            name = names[id(p)]
            whole = draw(gen, kind, arg, p.shape, p.dtype, dev)
            block = par.shard_leaf(whole, self.specs[name], axes).clone()
            del whole
            owner, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(owner), leaf, nn.Parameter(block))

    def _build(self, gen, dev):
        cfg, axes = self.cfg, self.axes
        self.embed = Embed(cfg, self.vocab_padded, gen, dev)
        self.layers = nn.ModuleList(tfm.Block(spec, cfg, gen, dev, axes=axes)
                                    for spec in cfg.layer_list())
        self.final_norm = Norm(cfg, cfg.d_model, dev)
        self.lm_head = None if cfg.tie_embeddings else LMHead(cfg, self.vocab_padded, gen, dev)
        self.encoder = Encoder(cfg, gen, dev, axes=axes) if cfg.encoder_segments else None
        self.pos_embed = (_init(gen, (8192, cfg.d_model), 0.02, torch_dtype(cfg.dtype), dev)
                          if cfg.pos_embedding == "learned" else None)

    @property
    def sharded(self) -> bool:
        """Whether this is one rank's part of a model over a mesh."""
        return self.axes is not None and self.axes.mesh is not None

    @property
    def vocab_padded(self) -> int:
        return vocab_pad(self.cfg.vocab, self.axes)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def set_layout(self, mode: str) -> None:
        """Hold the parameters in ``rules.param_specs(mode=...)``'s layout
        ("train" or "decode"), re-laying each leaf whose spec changes
        (collective: every rank calls it). A no-op with no mesh."""
        if not self.sharded or self.layout == mode:
            return
        specs = rules.param_specs(self.global_shapes, self.cfg, self.axes, mode=mode)
        for name, spec in specs.items():
            if spec != self.specs[name]:
                owner, _, leaf = name.rpartition(".")
                module = self.get_submodule(owner)
                old = getattr(module, leaf)
                new = par.relay_leaf(old.detach(), self.specs[name], spec, self.axes)
                setattr(module, leaf, nn.Parameter(new, requires_grad=old.requires_grad))
                del old
        self.specs, self.layout = specs, mode

    # ------------------------------------------------------------- caches
    def init_caches(self, B: int, S_max: int, memory_len: int = 0, device=None,
                    seq_shard: bool = False) -> list:
        """One zeroed cache per layer, on ``device`` (default: the model's);
        a cross block's holds ``memory_len`` memory positions. Under a mesh
        each is this rank's block of the caches of a global batch of B rows
        (``rules.cache_specs``: the batch over the batch axes that divide
        it, the KV heads over "model" where it divides them); with
        ``seq_shard`` (``repro``'s ``seq_shard_cache``) an attention cache
        (GQA, a ring, a cross cache, MLA's compressed one) holds every KV
        head, over the rank's block of its positions where their count
        divides over "model", and says so with ``seq_len``, that count
        (S_max, the ring's W, the memory's length)."""
        device = self.device if device is None else device
        cfg = self.cfg
        if not self.sharded:
            return [tfm.init_block_cache(spec, cfg, B, S_max, device, memory_len=memory_len)
                    for spec in cfg.layer_list()]
        whole = [tfm.init_block_cache(spec, cfg, B, S_max, "meta", memory_len=memory_len)
                 for spec in cfg.layer_list()]
        specs = rules.cache_specs(whole, cfg, self.axes, seq_shard=seq_shard)
        out = []
        for c, sp in zip(whole, specs):
            local = {}
            for key, mix in c.items():
                local[key] = {n: torch.zeros(par.local_shape(t.shape, sp[key][n], self.axes),
                                             dtype=t.dtype, device=device)
                              for n, t in mix.items()}
                seq = next((t.shape[1] for n, t in mix.items() if n in ("k", "ck", "c_kv")),
                           None)
                if seq_shard and seq is not None:  # the positions' global count
                    local[key]["seq_len"] = seq
            out.append(local)
        return out

    # ------------------------------------------------------------ forward
    def _embed_in(self, batch, positions):
        cfg = self.cfg
        x = embed_tokens(batch["tokens"], self.embed, self.axes)
        if cfg.name.startswith("recurrentgemma"):  # gemma's scaling, in x's dtype
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        if cfg.pos_embedding == "sinusoidal":
            x = x + sinusoidal_embed(positions, cfg.d_model).to(x.dtype)[None]
        elif cfg.pos_embedding == "learned":
            x = x + self.pos_embed[positions][None]
        return x

    def _memory(self, batch):
        """The encoder's output (whisper), the vision embeddings (the VLM),
        or None."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        if cfg.encoder_segments:
            frames = batch["frames"].to(dtype)
            pos = torch.arange(frames.shape[1], device=frames.device)
            h = frames + sinusoidal_embed(pos, cfg.d_model).to(dtype)[None]
            h, _, _ = tfm.run_segments(h, self.encoder.layers, cfg.encoder_segments, cfg,
                                       positions=pos, axes=self.axes)
            return apply_norm(h, self.encoder.final_norm, cfg)
        if cfg.n_vision_tokens:
            return batch["vision"].to(dtype)
        return None

    def _logits(self, x):
        x = par.copy_to(apply_norm(x, self.final_norm, self.cfg), self.axes)
        if self.lm_head is None:
            return x @ self.embed.table.T
        return x @ self.lm_head.w

    def forward(self, batch, caches=None, decode: bool = False, pos=None):
        """Returns (logits, new_caches, aux). ``pos``: the decode position
        (S == 1), one int or 0-d tensor for the whole batch, or a (B,)
        tensor with one position per row (continuous batching:
        ``serve/batching.py``); otherwise the positions are 0..S-1. Under a
        mesh ``batch`` is this rank's rows, the logits its vocabulary
        block, and the experts are put in the layout of the pass first
        (``set_layout``)."""
        self.set_layout("decode" if decode else "train")
        tokens = batch["tokens"]
        B, S = tokens.shape
        if decode:
            if pos is None:
                raise ValueError("decode needs the position pos")
            positions = torch.as_tensor(pos, dtype=torch.long, device=tokens.device)
            if positions.dim() == 0:
                positions = positions.reshape(1)
            elif positions.shape != (B,):
                raise ValueError(f"decode positions of shape {tuple(positions.shape)}: "
                                 f"one for the batch, or ({B},), one a row")
        else:
            positions = torch.arange(S, device=tokens.device)
        x = self._embed_in(batch, positions)
        memory = None if decode else self._memory(batch)
        x, new_caches, aux = tfm.run_segments(
            x, self.layers, self.cfg.segments, self.cfg,
            positions=positions, caches=caches, decode=decode, memory=memory, axes=self.axes,
        )
        return self._logits(x), new_caches, aux
