"""Synthetic data pipeline with sort-based length bucketing:
``repro/data/pipeline.py``.

Documents are bucketed by length with the unified sort front end
(``repro_torch.sort(..., want="order")``) before packing, which minimizes
padding waste. The lengths are heavily duplicated keys (a few hundred
distinct values), the investigator's case. The backend is the planner's:
a round above ``external_threshold`` documents streams through the
out-of-core backend, the rest run in one sim sort. The sort runs on the
card unless the caller passes ``device="cpu"`` (the device rule,
``repro_torch/device.py``); the corpus, the order and the batches are
host numpy arrays, as in ``repro``, and the train step moves batches to
the model's device.

Everything is deterministic in (seed, host_id): the corpus draws from
``repro``'s numpy streams, so both packages pack the same batches.

With ``axes`` over a mesh the loader yields this rank's block of each
global batch (``batch_block``: the batch dimension over
``rules.fit_batch_axes``). Every rank packs the same global batches, the
data round's length sort included, one sort computed alike on each rank,
and keeps its block.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.splitters import SortConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    grad_accum: int = 1
    vocab: int = 512
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    zipf_a: float = 1.2
    mean_doc_len: float = 350.0
    bucket_docs: int = 4096  # docs per bucketing round
    bucket_procs: int = 8  # virtual processors for the length sort
    # rounds larger than this go through the out-of-core path (stream)
    bucket_external_docs: int = 1 << 16


def _zipf_tokens(rng, n, vocab, a):
    # Zipf over the vocab, rejection-free via inverse CDF approximation
    u = np.maximum(rng.random(n), 1e-12)
    ranks = np.minimum(u ** (-1.0 / (a - 1.0)), float(vocab - 1))
    return ranks.astype(np.int32)


def doc_lengths(rng, n: int, cfg: DataConfig) -> np.ndarray:
    """``n`` document lengths as ``SyntheticCorpus.docs`` draws them:
    lognormal around ``mean_doc_len``, at least 8, at most 4 * seq_len."""
    lens = np.maximum(8, rng.lognormal(np.log(cfg.mean_doc_len), 0.6, n).astype(np.int64))
    return np.minimum(lens, 4 * cfg.seq_len)


class SyntheticCorpus:
    """Stream of variable-length synthetic documents."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng((cfg.seed, cfg.host_id))

    def docs(self, n: int):
        for L in doc_lengths(self.rng, n, self.cfg):
            yield _zipf_tokens(self.rng, int(L), self.cfg.vocab, self.cfg.zipf_a)


def bucket_by_length_external(doc_lens: np.ndarray, n_procs: int, sort_cfg=SortConfig(), *,
                              chunk_docs: int = 1 << 16, device=None) -> np.ndarray:
    """Corpus-scale length bucketing, pinned to the out-of-core backend:
    ``bucket_by_length`` with the planner's choice forced to stream."""
    return bucket_by_length(doc_lens, n_procs, sort_cfg, external_threshold=chunk_docs,
                            _where="stream", device=device)


def bucket_by_length(doc_lens: np.ndarray, n_procs: int, sort_cfg=SortConfig(), *,
                     external_threshold: int | None = None, _where=None,
                     device=None) -> np.ndarray:
    """Document ids in globally sorted (ascending length, stable) order, as
    a host numpy array, from ``repro_torch.sort`` on ``device`` (None: the
    card) with ``repro``'s limits and capacity factor 2.0."""
    from repro_torch.core import api as sort_api
    from repro_torch.core.planner import SortLimits

    limits = SortLimits(n_procs=n_procs, chunk_elems=external_threshold or (1 << 16),
                        stream_threshold=external_threshold)
    out = sort_api.sort(np.asarray(doc_lens).astype(np.int32), want="order", where=_where,
                        limits=limits, config=dataclasses.replace(sort_cfg, capacity_factor=2.0),
                        device=device)
    return out.order().cpu().numpy()


def batch_block(batch: dict, axes) -> dict:
    """This rank's block of a global batch of (accum, B, ...) arrays or
    tensors (``rules.batch_specs``); the whole batch with no mesh."""
    from repro_torch.sharding import parallel as par
    from repro_torch.sharding import rules

    if axes is None or axes.mesh is None:
        return batch
    specs = rules.batch_specs(batch, axes)
    return {k: par.shard_leaf(v, specs[k], axes) for k, v in batch.items()}


class PackedLoader:
    """Packs length-bucketed documents into (accum, B, S) token/label
    batches. Labels are next-token targets, -1 on padding. ``device``: where
    the length sort runs (None: the card). ``axes``: yield this rank's
    block of each batch (module docstring)."""

    def __init__(self, cfg: DataConfig, model_cfg=None, device=None, axes=None):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg)
        self.model_cfg = model_cfg
        self.device = device
        self.axes = axes
        self._step = 0

    def fast_forward(self, step: int):
        # as repro's: makes (step - position) batches without moving the position
        for _ in range(step - self._step):
            self._make_batch()

    def _pack_round(self):
        cfg = self.cfg
        docs = list(self.corpus.docs(cfg.bucket_docs))
        lens = np.array([len(d) for d in docs])
        order = bucket_by_length(lens, cfg.bucket_procs,
                                 external_threshold=cfg.bucket_external_docs,
                                 device=self.device)
        seqs = []
        cur = []
        cur_len = 0
        for i in order:
            d = docs[int(i)]
            while len(d):
                take = min(len(d), cfg.seq_len + 1 - cur_len)
                cur.append(d[:take])
                cur_len += take
                d = d[take:]
                if cur_len == cfg.seq_len + 1:
                    seqs.append(np.concatenate(cur))
                    cur, cur_len = [], 0
        return seqs

    def _make_batch(self):
        cfg = self.cfg
        need = cfg.grad_accum * cfg.global_batch
        seqs: list = []
        while len(seqs) < need:
            seqs.extend(self._pack_round())
        arr = np.stack(seqs[:need]).reshape(cfg.grad_accum, cfg.global_batch, cfg.seq_len + 1)
        batch = {
            "tokens": arr[..., :-1].astype(np.int32),
            "labels": arr[..., 1:].astype(np.int32),
        }
        if self.model_cfg is not None:
            d = self.model_cfg.d_model
            rng = np.random.default_rng((cfg.seed, 7, self._step))
            if self.model_cfg.encoder_segments:
                batch["frames"] = rng.standard_normal(
                    (cfg.grad_accum, cfg.global_batch, cfg.seq_len, d)).astype(np.float32)
            if self.model_cfg.n_vision_tokens:
                batch["vision"] = rng.standard_normal(
                    (cfg.grad_accum, cfg.global_batch, self.model_cfg.n_vision_tokens, d)
                ).astype(np.float32)
        return batch

    def __iter__(self):
        while True:
            b = batch_block(self._make_batch(), self.axes)
            self._step += 1
            yield b
