"""Continuous batching: a slot scheduler over the static decode caches.

The port of ``repro/serve/batching.py``, in eager PyTorch on the model's
device. The decode step always runs the whole (n_slots, 1) batch, each
slot at its own position (the per-slot decode of
``models/attention.py``). New requests are admitted into free slots
between steps: the prompt is prefilled as a (1, L) forward
(``engine.make_prefill``) and its caches are spliced into the slot's row,
zero-padded to the end of the row; a finished sequence frees its slot at
once, so short requests never wait for long ones. Decoding is greedy
(argmax over the real vocabulary). A free slot has position -1 and
decodes at position 0, writing into its own row only; a sequence ends at
its token budget or at position ``s_max - 1``.

It serves what ``repro``'s serves, rope-positioned models without
windowed caches (GQA and MLA, dense and MoE: ``_splice`` walks the
compressed MLA caches as any other), and refuses the rest with
``repro``'s AssertionError: models with memory (whisper's encoder, the
VLM's vision tokens) too, whose prefill needs inputs a request does not
carry (``repro``'s fails there, with a KeyError on the VLM).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.serve.engine import make_prefill, make_serve_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list


@torch.no_grad()
def _splice(full, part, slot: int):
    """Write ``part`` (a (1, L) prefill's caches) into batch row ``slot``
    of ``full`` (the batcher's (n_slots, s_max, ...) caches), in place,
    zero-padded over the rest of the row, as ``repro``'s ``_splice`` pads.
    Both are the model's cache structure: lists and dicts of tensors."""
    if isinstance(full, dict):
        for name in full:
            _splice(full[name], part[name], slot)
    elif isinstance(full, (list, tuple)):
        for f, p in zip(full, part, strict=True):
            _splice(f, p, slot)
    else:
        L = part.shape[1]
        if L > full.shape[1]:
            raise ValueError(f"a prompt of {L} tokens does not fit the slot's "
                             f"{full.shape[1]} positions (s_max)")
        row = full[slot]
        row[:L].copy_(part[0])
        row[L:].zero_()
    return full


class ContinuousBatcher:
    """Greedy continuous batching of ``model`` (``models.model.Model``,
    which holds its parameters) over ``n_slots`` slots of ``s_max``
    positions each."""

    def __init__(self, model, n_slots: int, s_max: int):
        cfg = model.cfg
        if getattr(model, "sharded", False):
            raise ValueError("continuous batching runs on one device, as repro's batcher has "
                             "no mesh; serve a sharded model through serve.engine")
        if cfg.encoder_segments or cfg.n_vision_tokens:
            raise AssertionError("continuous batching serves no model with memory (encoder "
                                 "frames, vision tokens); use serve.engine for them")
        if cfg.pos_embedding != "rope" or cfg.sliding_window:
            raise AssertionError("continuous batching supports rope/non-windowed archs; "
                                 "use serve.engine for the others")
        if any(s.mixer in ("rglru", "mamba") for s in cfg.layer_list()):
            raise AssertionError("continuous batching supports no recurrent mixers "
                                 "(rglru, mamba); use serve.engine for them")
        self.model = model
        self.n_slots = n_slots
        self.s_max = s_max
        self.caches = model.init_caches(n_slots, s_max)
        self.positions = np.full(n_slots, -1, np.int64)  # -1 = free slot
        self.budget = np.zeros(n_slots, np.int64)
        self.rids = np.full(n_slots, -1, np.int64)
        self.last_tok = np.zeros((n_slots, 1), np.int32)
        self.out_tokens: dict[int, list] = {}
        self.queue: deque[Request] = deque()
        self._step = make_serve_step(model)
        self._prefill = make_prefill(model)

    # ------------------------------------------------------------- admit
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @torch.no_grad()
    def _admit(self) -> None:
        vocab = self.model.cfg.vocab
        for slot in range(self.n_slots):
            if self.positions[slot] >= 0 or not self.queue:
                continue
            req = self.queue.popleft()
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int32)[None],
                                     device=self.model.device)
            logits, pre = self._prefill({"tokens": prompt})
            _splice(self.caches, pre, slot)
            tok = int(logits[0, 0, :vocab].argmax())
            self.positions[slot] = len(req.prompt)
            self.budget[slot] = req.max_new_tokens - 1
            self.rids[slot] = req.rid
            self.last_tok[slot, 0] = tok
            self.out_tokens[req.rid] = [tok]

    # -------------------------------------------------------------- step
    @torch.no_grad()
    def step(self) -> list:
        """Admit, then one decode step for all slots. Returns the
        Completions that finished in it."""
        self._admit()
        active = self.positions >= 0
        if not active.any():
            return []
        dev = self.model.device
        pos = torch.from_numpy(np.where(active, self.positions, 0)).to(dev)
        logits, self.caches = self._step(self.caches, torch.from_numpy(self.last_tok).to(dev),
                                         pos)
        nxt = logits[:, 0, :self.model.cfg.vocab].argmax(-1).to(torch.int32).cpu().numpy()
        done = []
        for slot in range(self.n_slots):
            if not active[slot]:
                continue
            if self.budget[slot] > 0:
                self.out_tokens[self.rids[slot]].append(int(nxt[slot]))
                self.last_tok[slot, 0] = nxt[slot]
                self.positions[slot] += 1
                self.budget[slot] -= 1
            if self.budget[slot] == 0 or self.positions[slot] >= self.s_max - 1:
                rid = int(self.rids[slot])
                done.append(Completion(rid, self.out_tokens.pop(rid)))
                self.positions[slot] = -1
                self.rids[slot] = -1
        return done

    def run(self, requests, max_steps: int = 10_000) -> dict:
        """Submit ``requests`` and step until every one has finished (or
        ``max_steps``): {rid: tokens}."""
        for r in requests:
            self.submit(r)
        out = {}
        steps = 0
        while (self.queue or (self.positions >= 0).any()) and steps < max_steps:
            for c in self.step():
                out[c.rid] = c.tokens
            steps += 1
        return out
