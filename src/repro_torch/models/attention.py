"""GQA and MLA attention with chunked prefill, flash prefill and cached
decode.

The port of ``repro/models/attention.py``'s GQA mixer (QKV bias, qk-norm,
rope) and MLA mixer (deepseek-v3). Each branch keeps the rounding points
of its JAX counterpart, so that a bfloat16 comparison with ``repro``
differs only by the order of accumulation:

  * ``_grouped_attn`` forms the scores in the input dtype, then softmaxes
    in float32 and casts the probabilities back to v's dtype before PV;
  * ``_flash_attn_train`` (``_tile_update``) accumulates both products in
    float32 and rounds p to v's dtype before PV;
  * prefill at S >= FLASH_MIN_SEQ with cfg.flash_attention calls
    ``kernels.flash.flash_attention``, as ``repro`` calls its Pallas kernel
    on a TPU: on the card the CUDA kernel, on the CPU its plain twin,
    which keeps everything in float32 as the Pallas kernel does.

Decode caches are full-length (B, S_max, KV, dh) k/v buffers. Decode
writes the new entry into them in place (``repro`` returns updated
copies): the cache of a long prompt is gigabytes, and the old buffers are
never read again.

A sliding window of W keys (``window``, recurrentgemma's local attention)
bands the causal mask (q - k < W), and at prefill each query chunk of
Q_CHUNK rows attends to its band of W + Q_CHUNK keys only, so the cost is
linear in the sequence. Its cache is a ring of min(W, S_max) k/v entries
with a ``pos`` side-car (int32, -1 where empty): prefill keeps the last
min(W, S) entries densely (``serve.engine.extend_caches`` re-slots them),
and decode writes the entry of position p at slot p % W and masks each
slot by the position it holds. Flash never serves a window (``repro``'s
condition).

MLA (``mla_forward``) projects q through a LoRA pair (``wq_a``, ``q_ln``,
``wq_b``) and the keys and values through one compressed latent c_kv
(``wkv_a``, ``kv_ln``) plus one rope key k_pe shared by every head. Prefill
expands c_kv through ``wk_b`` and ``wv_b`` per position, so q and k are
qk_nope_dim + qk_rope_dim wide and v v_head_dim wide: at deepseek-v3's
widths flash takes (dqk, dv) = (192, 128). Decode keeps the compressed
(c_kv, k_pe) cache and folds ``wk_b`` into q and ``wv_b`` into the output
(the absorbed products), so it never expands the cache.

Decode takes one position for the whole batch, or one per row (a (B,)
tensor with B > 1: continuous batching, ``serve/batching.py``), as
``repro``'s per-slot path: its own rope angles, its own cache position,
its own causal mask; with a window it takes one position only (the
batcher refuses windowed configs).

Under a mesh (``axes``) GQA self-attention is tensor-parallel over
"model", as ``repro``'s partition specs put it: ``repro`` pads the heads
to a multiple of the model axis (``Axes.pad_heads``), ``wq``/``bq`` hold
this rank's heads, ``wo`` their rows, and the output is summed over
"model" (``reduce_from``). k and v follow ``Axes.kv_spec``: sharded with
the heads when "model" divides the KV heads, else replicated, and then a
rank projects only the KV groups its own heads read (one gather of them
per head where the groups do not split evenly). The replicated weights
(the KV projections then, and the q/k norms) go through ``copy_to``:
their gradient is the sum of the ranks' parts. Prefill and decode under a
mesh (``_serve_tp``) keep the cache in ``rules.cache_specs``' layout: the
rank's KV heads (or every KV head), or with ``seq_shard`` (a cache
carrying ``seq_len``) every KV head over the rank's block of its
positions, the softmax then combined over "model" (``_attend``). A
sliding window's bands are over the rank's heads; its ring holds ``pos``
whole on every rank, and with ``seq_shard`` its W slots split over
"model" where they divide: the rank that holds slot p % W writes
position p, and every rank masks its slots by ``pos``.

Cross-attention (``gqa_forward`` with ``memory`` (B, M, d), or with a
cache holding ``ck``/``cv``) projects the keys and values from the memory
(whisper's encoder output, the VLM's vision tokens), with no rope and no
mask, through ``_grouped_attn`` over all M keys, unchunked as in
``repro``. Prefill returns those projections as the cache; decode reads
them and returns the cache as it was, never writing into it. A VLM's
cross module holds a float32 scalar ``gate`` (zero at init) and scales
its output by tanh(gate).

Cross-attention under a mesh splits ``wq``, ``wk``, ``wv`` and ``wo`` by
heads as self-attention does; the memory enters through ``copy_to``, and
a VLM's replicated ``gate`` too (``_gated``: each rank scales its part of
the row-parallel sum, so the gate's gradient is the sum of the ranks'
parts). The ``ck`` / ``cv`` caches follow ``Axes.kv_spec``, or with
``seq_shard`` split over the memory's positions (``_cross_serve_tp``).

MLA under a mesh holds the rank's heads: the columns of ``wq_b``,
``wk_b`` and ``wv_b`` and the rows of ``wo``; the replicated ``wq_a``,
``q_ln``, ``wkv_a`` and ``kv_ln`` are computed whole on every rank and
their outputs enter the region through ``copy_to`` (``_mla_qkv``).
Prefill sends the rank's heads through flash; the absorbed decode folds
the rank's ``wk_b`` and ``wv_b`` over the compressed cache, whole on
every rank or, with ``seq_shard``, split over its positions and combined
by a log-sum-exp over every head's query (``mla_forward``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash import flash_attention
from repro_torch.models.layers import (_const, _init, apply_rope, make_cache, rms_norm_simple,
                                      rope_table, torch_dtype)
from repro_torch.sharding import parallel as par

Q_CHUNK = 512
# flash attention pays (tile re-reads) only once the score matrix stops
# fitting comfortably: below this sequence length the single-level chunked
# path is strictly better on the memory term (repro's own threshold).
FLASH_MIN_SEQ = 8192


# ----------------------------------------------------------------- params


class Attention(nn.Module):
    """``init_attention``: ``wq`` (d, H*dh), ``wk``/``wv`` (d, KV*dh),
    ``wo`` (H*dh, d); zero biases ``bq``/``bk``/``bv`` with cfg.attn_bias;
    float32 ``q_norm``/``k_norm`` (ones) with cfg.qk_norm; for a cross
    module of a VLM (``cross`` and cfg.n_vision_tokens) the float32 scalar
    ``gate`` (zero). With ``axes``, H is padded to the model axis."""

    def __init__(self, cfg, gen, device=None, cross: bool = False, axes=None):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        d, dh, KV = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
        H = axes.pad_heads(cfg.n_heads) if axes else cfg.n_heads
        s = d ** -0.5
        self.wq = _init(gen, (d, H * dh), s, dtype, device)
        self.wk = _init(gen, (d, KV * dh), s, dtype, device)
        self.wv = _init(gen, (d, KV * dh), s, dtype, device)
        self.wo = _init(gen, (H * dh, d), (H * dh) ** -0.5, dtype, device)
        bias = cfg.attn_bias
        self.bq = _const(0.0, (H * dh,), dtype, device) if bias else None
        self.bk = _const(0.0, (KV * dh,), dtype, device) if bias else None
        self.bv = _const(0.0, (KV * dh,), dtype, device) if bias else None
        norm = cfg.qk_norm
        self.q_norm = _const(1.0, (dh,), torch.float32, device) if norm else None
        self.k_norm = _const(1.0, (dh,), torch.float32, device) if norm else None
        gated = cross and cfg.n_vision_tokens  # tanh-gated cross-attention
        self.gate = _const(0.0, (), torch.float32, device) if gated else None


class MLA(nn.Module):
    """``init_mla``: ``wq_a`` (d, q_lora_rank), float32 ``q_ln`` (ones),
    ``wq_b`` (q_lora_rank, H*(qk_nope_dim + qk_rope_dim)), ``wkv_a`` (d,
    kv_lora_rank + qk_rope_dim), float32 ``kv_ln`` (ones), ``wk_b``
    (kv_lora_rank, H*qk_nope_dim), ``wv_b`` (kv_lora_rank, H*v_head_dim),
    ``wo`` (H*v_head_dim, d), each at ``repro``'s scale; with ``axes``, H
    padded to the model axis."""

    def __init__(self, cfg, gen, device=None, axes=None):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        d = cfg.d_model
        H = axes.pad_heads(cfg.n_heads) if axes else cfg.n_heads
        qn, qr, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        qa, r = cfg.q_lora_rank, cfg.kv_lora_rank
        self.wq_a = _init(gen, (d, qa), d ** -0.5, dtype, device)
        self.q_ln = _const(1.0, (qa,), torch.float32, device)
        self.wq_b = _init(gen, (qa, H * (qn + qr)), qa ** -0.5, dtype, device)
        self.wkv_a = _init(gen, (d, r + qr), d ** -0.5, dtype, device)
        self.kv_ln = _const(1.0, (r,), torch.float32, device)
        self.wk_b = _init(gen, (r, H * qn), r ** -0.5, dtype, device)
        self.wv_b = _init(gen, (r, H * vd), r ** -0.5, dtype, device)
        self.wo = _init(gen, (H * vd, d), (H * vd) ** -0.5, dtype, device)


# ------------------------------------------------------------ core einsum


def _grouped_attn(q, k, v, mask, scale):
    """q: (B,S,H,dh) with H = KV*rep; k/v: (B,T,KV,dk). mask: broadcastable
    to (B,KV,rep,S,T) or None. fp32 softmax."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, S, KV, rep, dh)
    scores = torch.einsum("bskrd,btkd->bkrst", qg, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum("bkrst,btkd->bskrd", probs, v)
    return ctx.reshape(B, S, KV * rep, v.shape[-1])


def _causal_mask(q_pos, k_pos, window: int = 0):
    """(S, T) bool mask; window > 0 adds the sliding-window band."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _chunked_attn(q, k, v, *, causal, q_positions, k_positions, scale, window: int = 0,
                  remat: bool = False):
    """Query chunks of Q_CHUNK rows; with a causal window each chunk takes
    only its band of window + Q_CHUNK keys, [start - window, start +
    Q_CHUNK) clamped into the keys, when the band is shorter than them.
    With ``remat`` (cfg.remat while autograd records) each chunk is
    rematerialized in the backward: its float32 scores and probabilities,
    0.8 GB a chunk at 4096 keys and 64 heads, are not kept between the
    forward and the backward (the same values are computed again)."""
    S, T = q.shape[1], k.shape[1]
    if S <= Q_CHUNK:
        mask = _causal_mask(q_positions, k_positions, window)[None, None, None] if causal else None
        return _grouped_attn(q, k, v, mask, scale)
    if S % Q_CHUNK:
        raise ValueError(f"seq {S} must be divisible by Q_CHUNK {Q_CHUNK}")
    band = window + Q_CHUNK if (window and causal) else 0
    chunks = []
    for start in range(0, S, Q_CHUNK):
        qp = q_positions[start:start + Q_CHUNK]
        kc, vc, kp = k, v, k_positions
        if band and band < T:
            ks = min(max(start - window, 0), T - band)
            kc, vc, kp = k[:, ks:ks + band], v[:, ks:ks + band], k_positions[ks:ks + band]
        mask = _causal_mask(qp, kp, window)[None, None, None] if causal else None
        qc = q[:, start:start + Q_CHUNK]
        if remat:
            chunks.append(checkpoint(_grouped_attn, qc, kc, vc, mask, scale, use_reentrant=False))
        else:
            chunks.append(_grouped_attn(qc, kc, vc, mask, scale))
    return torch.cat(chunks, dim=1)


# ----------------------------------------------------- flash attention


def _pick_chunks(B, H, S, T, budget_bytes=64 << 20):
    cq = min(S, 512)
    ck = min(T, 1024)
    while B * H * cq * ck * 4 > budget_bytes and ck > 128:
        ck //= 2
    while B * H * cq * ck * 4 > budget_bytes and cq > 128:
        cq //= 2
    while S % cq:
        cq //= 2
    while T % ck:
        ck //= 2
    return max(cq, 1), max(ck, 1)


def _tile_update(qc, kc, vc, m, l, acc, qp, kp, scale, causal):
    """One online-softmax tile update. qc: (B,cq,KV,rep,dh); kc/vc:
    (B,ck,KV,d*); m/l: (B,KV,rep,cq); acc: (B,KV,rep,cq,dv). Both products
    accumulate in f32 (JAX's preferred_element_type); p is rounded to v's
    dtype before PV, as in ``repro``."""
    s = torch.einsum("bqkrd,btkd->bkrqt", qc.float(), kc.float()) * scale
    if causal:
        s = torch.where((qp[:, None] >= kp[None, :])[None, None, None], s, -torch.inf)
    m_new = torch.maximum(m, s.amax(-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    finite = torch.isfinite(m)
    corr = torch.exp(torch.where(finite, m - m_safe, -torch.inf))
    corr = torch.where(finite, corr, 0.0)
    l_new = l * corr + p.sum(-1)
    pv = torch.einsum("bkrqt,btkd->bkrqd", p.to(vc.dtype).float(), vc.float())
    return m_new, l_new, acc * corr[..., None] + pv


def _finalize(acc, l, dtype):
    norm = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B,KV,rep,cq,dv)
    B, KV, rep, cq, dv = norm.shape
    return norm.permute(0, 3, 1, 2, 4).reshape(B, cq, KV * rep, dv).to(dtype)


def _flash_attn_train(q, k, v, *, causal, scale):
    """Outer-q / inner-k online softmax over all key chunks: ``repro``'s
    differentiable flash path, in plain PyTorch (autograd takes its
    backward through the tiles, as ``jax.grad`` does through ``repro``'s)."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = H // KV
    cq, ck = _pick_chunks(B, H, S, T)
    rows = []
    for qs in range(0, S, cq):
        qc = q[:, qs:qs + cq].reshape(B, cq, KV, rep, dh)
        qp = torch.arange(qs, qs + cq, device=q.device)
        m = torch.full((B, KV, rep, cq), -torch.inf, device=q.device)
        l = torch.zeros((B, KV, rep, cq), device=q.device)
        acc = torch.zeros((B, KV, rep, cq, dv), device=q.device)
        for ks in range(0, T, ck):
            kp = torch.arange(ks, ks + ck, device=q.device)
            m, l, acc = _tile_update(qc, k[:, ks:ks + ck], v[:, ks:ks + ck], m, l, acc,
                                     qp, kp, scale, causal)
        rows.append(_finalize(acc, l, v.dtype))
    return torch.cat(rows, dim=1)


def _flash_attn(q, k, v, *, causal, scale, inference: bool):
    if inference:
        # the flash kernel (kernels/flash.py): on the card the CUDA kernel,
        # on the CPU its plain twin
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return _flash_attn_train(q, k, v, causal=causal, scale=scale)


# ------------------------------------------------------------- GQA mixer


def _proj(x, w, b=None):
    y = x @ w
    return y + b if b is not None else y


def _kv_groups(cfg, g, H: int):
    """(lo, hi, idx): the KV groups [lo, hi) of all cfg.n_kv_heads that
    this rank's H heads read when the KV heads are replicated over
    "model" (``g``), with ``idx`` the group of each head, counted from lo,
    where the heads do not split evenly over them (else None)."""
    rep = H * g.size // cfg.n_kv_heads
    first = g.index * H
    lo, hi = first // rep, (first + H - 1) // rep + 1
    n = hi - lo
    idx = torch.arange(first, first + H) // rep - lo
    even = H % n == 0 and torch.equal(idx, torch.arange(H) // (H // n))
    return lo, hi, None if even else idx


def _tp_weights(p: Attention, cfg, axes, H: int):
    """(wk, wv, bk, bv, q_norm, k_norm, KV, idx) for this rank's H heads
    under a mesh: the KV projections of its own KV heads when they are
    sharded with the heads; when they are replicated, those of the KV
    groups [lo, hi) its heads read, with ``idx`` the group of each head
    where the heads do not split evenly over them (else None)."""
    dh = cfg.head_dim
    q_norm, k_norm = (None if n is None else par.copy_to(n, axes) for n in (p.q_norm, p.k_norm))
    if axes.kv_spec(cfg.n_kv_heads) is not None:
        return p.wk, p.wv, p.bk, p.bv, q_norm, k_norm, p.wk.shape[-1] // dh, None
    lo, hi, idx = _kv_groups(cfg, par.group(axes, axes.model), H)
    cols = slice(lo * dh, hi * dh)
    wk, wv = (par.copy_to(w, axes)[:, cols] for w in (p.wk, p.wv))
    bk, bv = (None if b is None else par.copy_to(b, axes)[cols] for b in (p.bk, p.bv))
    return wk, wv, bk, bv, q_norm, k_norm, hi - lo, None if idx is None else idx.to(p.wk.device)


def gqa_forward(x, p: Attention, cfg, *, causal: bool = True, window: int = 0,
                positions=None, rope: bool = True, cache=None, decode: bool = False,
                memory=None, axes=None):
    """Returns (out, new_cache). Prefill (``cache`` given, ``decode``
    False) returns the prompt's k/v as the cache; decode (S == 1) writes
    the new k/v at the one position in ``positions`` in place and attends
    over the cache up to it, or, with ``positions`` of shape (B,) and
    B > 1, each row at its own position (``_write_slots``). With a
    ``window``, prefill returns the ring of the last min(window, S) entries
    and decode writes into the ring (``_ring_decode``). ``memory`` (B, M,
    d), or a cache holding ``ck``/``cv``, makes it cross-attention
    (``_cross``). With ``axes`` the heads are this rank's (module
    docstring); prefill and decode under a mesh are ``_serve_tp``'s."""
    B, S, d = x.shape
    dh = cfg.head_dim
    H = p.wq.shape[-1] // dh
    KV = cfg.n_kv_heads
    scale = dh ** -0.5
    wk, wv, bk, bv, q_norm, k_norm, idx = p.wk, p.wv, p.bk, p.bv, p.q_norm, p.k_norm, None
    g = par.group(axes, axes.model if axes is not None else ())
    cross = memory is not None or (cache is not None and "ck" in cache)
    if g is not None and cache is not None:
        if cross:
            return _cross_serve_tp(x, p, cfg, axes, g, memory, cache)
        return _serve_tp(x, p, cfg, axes, g, causal=causal, window=window, positions=positions,
                         rope=rope, cache=cache, decode=decode)
    if g is not None:
        x = par.copy_to(x, axes)
        wk, wv, bk, bv, q_norm, k_norm, KV, idx = _tp_weights(p, cfg, axes, H)

    q = _proj(x, p.wq, p.bq).reshape(B, S, H, dh)
    if cfg.qk_norm:
        q = rms_norm_simple(q, q_norm, cfg.norm_eps)
    if cross:
        if g is not None:  # training under a mesh: this rank's heads over the memory
            memory = par.copy_to(memory, axes)
            k = _proj(memory, wk, bk).reshape(B, -1, KV, dh)
            v = _proj(memory, wv, bv).reshape(B, -1, KV, dh)
            if idx is not None:
                k, v = k[:, :, idx], v[:, :, idx]
            out = _grouped_attn(q, k, v, None, scale).reshape(B, S, H * dh) @ p.wo
            return par.reduce_from(_gated(out, p, axes), axes), None
        return _cross(q, p, cfg, memory, cache, scale)
    k = _proj(x, wk, bk).reshape(B, -1, KV, dh)
    v = _proj(x, wv, bv).reshape(B, -1, KV, dh)
    if cfg.qk_norm:
        k = rms_norm_simple(k, k_norm, cfg.norm_eps)
    if idx is not None:  # the KV group of each of this rank's heads
        k, v = k[:, :, idx], v[:, :, idx]

    if positions is None:
        positions = torch.arange(S, device=x.device)
    # per-slot positions (continuous batching): one decode position a row
    per_slot = decode and positions.dim() == 1 and positions.shape[0] == B and B > 1

    if rope:
        cos, sin = rope_table(positions, dh, cfg.rope_theta)
        if per_slot:  # (B, half) -> (B, 1, half)
            cos, sin = cos[:, None, :], sin[:, None, :]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if decode:
        if cache is None or S != 1:
            raise ValueError("decode takes one token (S == 1) and a cache")
        if window:
            if per_slot:
                raise ValueError("a sliding window decodes one position for the whole batch")
            ctx, new_cache = _ring_decode(q, k, v, cache, positions, window, scale)
            return ctx.reshape(B, S, H * dh) @ p.wo, new_cache
        if per_slot:
            ck, cv = _write_slots(cache["k"], k, positions), _write_slots(cache["v"], v, positions)
            t = torch.arange(ck.shape[1], device=x.device)
            mask = (t[None, :] <= positions.long()[:, None])[:, None, None, None, :]
        else:
            pos = positions.reshape(1).long()
            ck = cache["k"].index_copy_(1, pos, k)
            cv = cache["v"].index_copy_(1, pos, v)
            t = torch.arange(ck.shape[1], device=x.device)
            mask = (t <= pos)[None, None, None, None, :]
        ctx = _grouped_attn(q, ck, cv, mask, scale)
        return ctx.reshape(B, S, H * dh) @ p.wo, {"k": ck, "v": cv}

    # training / prefill: repro's condition (attention.py:400)
    if cfg.flash_attention and window == 0 and S >= FLASH_MIN_SEQ:
        # online-softmax tiles; the kernel at prefill (cache given <=> inference)
        ctx = _flash_attn(q, k, v, causal=causal, scale=scale, inference=cache is not None)
    else:
        ctx = _chunked_attn(q, k, v, causal=causal, q_positions=positions,
                            k_positions=positions, scale=scale, window=window,
                            remat=cfg.remat and torch.is_grad_enabled())
    out = par.reduce_from(ctx.reshape(B, S, H * dh) @ p.wo, axes)
    if cache is None:
        return out, None
    if window:  # the ring: the last W entries, densely, with their positions (copies)
        W = min(window, S)
        return out, {"k": k[:, -W:].clone(), "v": v[:, -W:].clone(),
                     "pos": positions[-W:].to(torch.int32)}
    return out, {"k": k, "v": v}


def _own_groups(t, cfg, axes, g, H: int):
    """The KV groups this rank's H heads read, from ``t`` (B, T, KV, dh)
    holding every KV head: its block where "model" splits the KV heads,
    else the groups ``_kv_groups`` names (one gather a head where they do
    not split evenly)."""
    if axes.kv_spec(cfg.n_kv_heads) is not None:
        n = cfg.n_kv_heads // g.size
        return t.narrow(2, g.index * n, n)
    lo, hi, idx = _kv_groups(cfg, g, H)
    t = t.narrow(2, lo, hi - lo)
    return t if idx is None else t[:, :, idx.to(t.device)]


def _own_heads(t, cfg, axes, g, H: int, kv_split: bool):
    """The KV groups this rank's H heads read, from ``t`` (B, T, KVl, dh):
    ``t`` itself where it holds this rank's KV heads, else (every KV head)
    ``_own_groups``."""
    return t if kv_split and t.shape[2] != cfg.n_kv_heads else _own_groups(t, cfg, axes, g, H)


def _heads_to_seq(t, g):
    """(B, S, KV/m, dh), this rank's KV heads over the whole sequence, to
    (B, S/m, KV, dh), every KV head over this rank's block of the
    sequence: one all-to-all over "model"."""
    B, S, n, dh = t.shape
    blocks = t.reshape(B, g.size, S // g.size, n, dh).transpose(0, 1)
    got = g.all_to_all(blocks.contiguous())  # row i: coordinate i's heads, my block
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // g.size, g.size * n, dh)


def _lse_attn(q, k, v, mask, scale, axes):
    """``_grouped_attn`` over a cache whose sequence is split over "model":
    this rank's block of keys for every head, the softmax's max and sum
    combined over the ranks (``parallel.all_max``, ``reduce_from``), and
    the blocks' partial contexts summed."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, S, KV, rep, dh)
    scores = torch.einsum("bskrd,btkd->bkrst", qg, k).float() * scale
    scores = torch.where(mask, scores, -1e30)
    top = par.all_max(scores.amax(-1, keepdim=True), axes)
    e = torch.exp(scores - top)
    probs = (e / par.reduce_from(e.sum(-1, keepdim=True), axes)).to(v.dtype)
    ctx = par.reduce_from(torch.einsum("bkrst,btkd->bskrd", probs, v), axes)
    return ctx.reshape(B, S, KV * rep, v.shape[-1])


def _cache_layout(t, S: int, seq_len, cfg, axes, g, kv_split: bool):
    """The cache layout of ``t`` (B, S, KVl, dh): this rank's KV heads, or
    every KV head where ``Axes.kv_spec`` replicates them, over all S
    positions. Unchanged without ``seq_len``; with it (``seq_shard``)
    every KV head over this rank's block of the S positions when S
    divides over "model" (an all-to-all from the heads, or a slice), else
    over all of them (an all-gather of the heads where they are split)."""
    if seq_len is None:
        return t
    if S % g.size == 0:
        n = S // g.size
        return _heads_to_seq(t, g) if kv_split else t.narrow(1, g.index * n, n).clone()
    return par.gather(t, 2, axes, axes.model) if kv_split else t


def _split_cache(seq_len, g) -> bool:
    """Whether a cache of ``seq_len`` positions (None: not ``seq_shard``)
    holds this rank's block of them."""
    return seq_len is not None and seq_len % g.size == 0


def _attend(q, ck, cv, mask, scale, axes, g, split: bool, own):
    """This rank's heads of q (B, S, H, dh) over a cache: its own KV groups
    of the whole cache (``own``), or, where the cache holds this rank's
    block of the positions for every KV head (``split``), every head's
    query over the block, the softmax combined over "model"
    (``_lse_attn``), and this rank's heads of the result."""
    if not split:
        return _grouped_attn(q, own(ck), own(cv), mask, scale)
    H = q.shape[2]
    qa = par.gather(q, 2, axes, axes.model)  # every head's query
    if mask is None:
        mask = torch.ones((1, 1, 1, 1, ck.shape[1]), dtype=torch.bool, device=q.device)
    return _lse_attn(qa, ck, cv, mask, scale, axes).narrow(2, g.index * H, H)


def _write_own(cache, at_global, new, first: int, n: int):
    """``new`` (B, 1, ...) into ``cache`` (B, n, ...), this rank's block of
    positions [first, first + n), at position ``at_global`` (a (1,) long
    tensor) when the block holds it; in place, with no host read."""
    at = (at_global - first).clamp(0, n - 1)
    mine = ((at_global >= first) & (at_global < first + n)).reshape((1,) * cache.dim())
    return cache.index_copy_(1, at, torch.where(mine, new, cache.index_select(1, at)))


def _serve_tp(x, p: Attention, cfg, axes, g, *, causal, window, positions, rope, cache, decode):
    """Prefill and decode of this rank's heads under a mesh (``g``: its
    group over "model"), as ``repro`` shards them by ``rules.cache_specs``.

    The cache layout is the cache's own: without ``seq_len`` it holds this
    rank's KV heads (every KV head where ``Axes.kv_spec`` replicates them)
    over the whole sequence; with ``seq_len`` (``seq_shard``) every KV
    head, over the rank's block of a sequence of seq_len positions when
    seq_len divides over "model", else over all of it. Prefill returns the
    prompt's k/v in the layout of the cache it is given
    (``_cache_layout``); decode writes the new entry (at the rank that
    holds its position) and attends, with the softmax combined over the
    ranks when the sequence is split (``_attend``).

    With a ``window`` the cache is a ring of W slots and ``pos`` (module
    docstring), ``pos`` whole on every rank; ``seq_len`` is W, and with
    ``seq_shard`` the ring's slots are split over "model" when it divides
    W: only the rank that holds slot p % W writes position p, and each
    rank masks its slots by ``pos``."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    H = p.wq.shape[-1] // dh
    scale = dh ** -0.5
    kv_split = axes.kv_spec(cfg.n_kv_heads) is not None
    seq_len = cache.get("seq_len")
    q = _proj(x, p.wq, p.bq).reshape(B, S, H, dh)
    k = _proj(x, p.wk, p.bk).reshape(B, S, -1, dh)  # this rank's KV heads, or all
    v = _proj(x, p.wv, p.bv).reshape(B, S, -1, dh)
    if cfg.qk_norm:
        q = rms_norm_simple(q, p.q_norm, cfg.norm_eps)
        k = rms_norm_simple(k, p.k_norm, cfg.norm_eps)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if decode and (S != 1 or positions.numel() != 1):
        raise ValueError("decode under a mesh takes one token (S == 1) at one position")
    if rope:
        cos, sin = rope_table(positions, dh, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)

    def own(t):
        return _own_heads(t, cfg, axes, g, H, kv_split)

    def out_of(ctx):
        return par.reduce_from(ctx.reshape(B, S, H * dh) @ p.wo, axes)

    marker = {} if seq_len is None else {"seq_len": seq_len}
    if not decode:
        kk, vv = own(k), own(v)
        if cfg.flash_attention and window == 0 and S >= FLASH_MIN_SEQ:
            ctx = _flash_attn(q, kk.contiguous(), vv.contiguous(), causal=causal, scale=scale,
                              inference=True)
        else:
            ctx = _chunked_attn(q, kk, vv, causal=causal, q_positions=positions,
                                k_positions=positions, scale=scale, window=window)
        if window:  # the ring: the last W entries, densely, with their positions
            W = min(window, S)
            k, v = k[:, -W:].clone(), v[:, -W:].clone()
            marker = {"pos": positions[-W:].to(torch.int32)}
            if seq_len is not None:
                marker["seq_len"] = W
            S_cache = W
        else:
            S_cache = S
            if seq_len is not None:
                marker["seq_len"] = S
        k, v = (_cache_layout(t, S_cache, seq_len, cfg, axes, g, kv_split) for t in (k, v))
        return out_of(ctx), {"k": k, "v": v, **marker}

    pos = positions.reshape(1).long()
    if seq_len is not None and kv_split:  # the new entry of every KV head
        k, v = (par.gather(t, 2, axes, axes.model) for t in (k, v))
    split = _split_cache(seq_len, g)
    n = cache["k"].shape[1]
    first = g.index * n if split else 0
    if window:
        at = pos % (seq_len if seq_len is not None else n)
        cpos = cache["pos"].index_copy_(0, at, pos.to(torch.int32))
        mine = cpos.narrow(0, first, n)
        valid = (mine >= 0) & (mine <= pos) & (pos - mine < window)
        marker["pos"] = cpos
    else:
        at = pos
        valid = first + torch.arange(n, device=x.device) <= pos
    if split:
        ck, cv = (_write_own(cache[name], at, t, first, n) for name, t in (("k", k), ("v", v)))
    else:
        ck, cv = cache["k"].index_copy_(1, at, k), cache["v"].index_copy_(1, at, v)
    ctx = _attend(q, ck, cv, valid[None, None, None, None, :], scale, axes, g, split, own)
    return out_of(ctx), {"k": ck, "v": cv, **marker}


def _gated(out, p: Attention, axes=None):
    """A VLM cross module's output times tanh(gate); under a mesh the
    replicated gate goes through ``copy_to`` (each rank scales its part of
    the row-parallel sum, so the gate's gradient is the sum of the ranks'
    parts)."""
    if p.gate is None:
        return out
    return torch.tanh(par.copy_to(p.gate, axes)).to(out.dtype) * out


def _cross_serve_tp(x, p: Attention, cfg, axes, g, memory, cache):
    """Cross-attention prefill (``memory`` given) and decode (the cache's
    ``ck``/``cv``) of this rank's heads under a mesh. The cross cache
    follows ``rules.cache_specs`` as ``_serve_tp``'s does: this rank's KV
    heads (or every KV head) over the whole memory, or with ``seq_len``
    (``seq_shard``) every KV head over the rank's block of the memory's
    positions when they divide over "model", the softmax then combined
    over the ranks. Returns (out, new_cache)."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    H = p.wq.shape[-1] // dh
    scale = dh ** -0.5
    kv_split = axes.kv_spec(cfg.n_kv_heads) is not None
    seq_len = cache.get("seq_len")
    q = _proj(x, p.wq, p.bq).reshape(B, S, H, dh)
    if cfg.qk_norm:
        q = rms_norm_simple(q, p.q_norm, cfg.norm_eps)

    def own(t):
        return _own_heads(t, cfg, axes, g, H, kv_split)

    if memory is not None:
        k = _proj(memory, p.wk, p.bk).reshape(B, -1, p.wk.shape[-1] // dh, dh)
        v = _proj(memory, p.wv, p.bv).reshape(B, -1, p.wv.shape[-1] // dh, dh)
        ctx = _grouped_attn(q, own(k), own(v), None, scale)
        M = k.shape[1]
        new_cache = {name: _cache_layout(t, M, seq_len, cfg, axes, g, kv_split)
                     for name, t in (("ck", k), ("cv", v))}
        if seq_len is not None:
            new_cache["seq_len"] = M
    else:
        split = _split_cache(seq_len, g)
        ctx = _attend(q, cache["ck"], cache["cv"], None, scale, axes, g, split, own)
        new_cache = cache
    out = _gated(ctx.reshape(B, S, H * dh) @ p.wo, p)
    return par.reduce_from(out, axes), new_cache


def _cross(q, p: Attention, cfg, memory, cache, scale):
    """Cross-attention of q (B, S, H, dh) over keys and values projected
    from ``memory`` (prefill and training: returned as the cache when one
    is given) or read from ``cache["ck"]``/``["cv"]`` (decode: the cache is
    returned as it was). No rope, no mask, no k_norm; the output times
    tanh(gate) where the module has one. Returns (out, new_cache)."""
    B, S, H, dh = q.shape
    if memory is not None:
        k = _proj(memory, p.wk, p.bk).reshape(B, -1, cfg.n_kv_heads, dh)
        v = _proj(memory, p.wv, p.bv).reshape(B, -1, cfg.n_kv_heads, dh)
        new_cache = {"ck": k, "cv": v} if cache is not None else None
    else:
        k, v, new_cache = cache["ck"], cache["cv"], cache
    return _gated(_grouped_attn(q, k, v, None, scale).reshape(B, S, H * dh) @ p.wo, p), new_cache


def _ring_decode(q, k, v, cache, positions, window: int, scale):
    """One decode step over a ring cache, at the one position of
    ``positions``: the new k/v and its position written at slot pos % W in
    place, every slot masked by the position it holds (valid when 0 <= p
    <= pos and pos - p < window). Returns (ctx, cache)."""
    W = cache["k"].shape[1]
    pos = positions.reshape(1).long()
    slot = pos % W
    ck = cache["k"].index_copy_(1, slot, k)
    cv = cache["v"].index_copy_(1, slot, v)
    cpos = cache["pos"].index_copy_(0, slot, pos.to(torch.int32))
    valid = (cpos >= 0) & (cpos <= pos) & (pos - cpos < window)
    ctx = _grouped_attn(q, ck, cv, valid[None, None, None, None, :], scale)
    return ctx, {"k": ck, "v": cv, "pos": cpos}


def _write_slots(cache, new, positions):
    """Row b of ``new`` (B, 1, ...) into ``cache`` (B, S_max, ...) at
    position ``positions[b]``, in place: ``repro``'s ``.at[bidx,
    pos].set(..., mode="drop")``, a negative position counted from the end
    as jax indexes, and a position outside the cache dropped (its row
    keeps its old entry) by masking, with no host read."""
    S_max = cache.shape[1]
    pos = positions.long()
    pos = torch.where(pos < 0, pos + S_max, pos)
    keep = (pos >= 0) & (pos < S_max)
    at = pos.clamp(0, S_max - 1)
    rows = torch.arange(cache.shape[0], device=cache.device)
    old = cache[rows, at]
    keep = keep.reshape((-1,) + (1,) * (old.dim() - 1))
    cache[rows, at] = torch.where(keep, new[:, 0], old)
    return cache


def gqa_cache_layout(cfg, B: int, S_max: int, window: int = 0) -> dict:
    """``init_gqa_cache``'s tensors as ``{name: (shape, dtype, fill)}``."""
    dtype = torch_dtype(cfg.dtype)
    W = min(window, S_max) if window else S_max
    shape = (B, W, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": (shape, dtype, 0), "v": (shape, dtype, 0)}
    if window:
        c["pos"] = ((W,), torch.int32, -1)
    return c


def init_gqa_cache(cfg, B: int, S_max: int, window: int = 0, device=None):
    """Zeroed k and v of (B, S_max, KV, dh); with a window, a ring of
    min(window, S_max) entries and its ``pos`` (int32, all -1)."""
    return make_cache(gqa_cache_layout(cfg, B, S_max, window), device)


# ------------------------------------------------------------- MLA mixer


def _mla_qkv(x, p: MLA, cfg, H, axes=None):
    """Shared q / compressed-kv computation. Returns q_nope (B,S,H,qn),
    q_pe (B,S,H,qr), c_kv (B,S,r), k_pe (B,S,qr). Under a mesh every rank
    computes the replicated ``wq_a``, ``q_ln``, ``wkv_a`` and ``kv_ln``
    whole, and the tensor-parallel region begins at their outputs: q's
    latent, c_kv and k_pe go through ``copy_to``, so that each of them
    gets the sum of the ranks' heads' gradients before it reaches those
    weights, which then take the whole gradient on every rank, summed over
    the heads before the tokens as on one device; ``wq_b`` holds this
    rank's H heads."""
    B, S, _ = x.shape
    qn, qr, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    q_lat = rms_norm_simple(x @ p.wq_a, p.q_ln, cfg.norm_eps)
    q = (par.copy_to(q_lat, axes) @ p.wq_b).reshape(B, S, H, qn + qr)
    kv = x @ p.wkv_a
    c_kv = rms_norm_simple(kv[..., :r], p.kv_ln, cfg.norm_eps)
    return q[..., :qn], q[..., qn:], par.copy_to(c_kv, axes), par.copy_to(kv[..., r:], axes)


def mla_forward(x, p: MLA, cfg, *, positions=None, cache=None, decode: bool = False,
                axes=None):
    """MLA attention; returns (out, new_cache). Prefill and training expand
    k and v per position (flash at S >= FLASH_MIN_SEQ with
    cfg.flash_attention, q and k qk_nope_dim + qk_rope_dim wide, v
    v_head_dim wide); prefill returns the compressed (c_kv, k_pe) as the
    cache. Decode (S == 1) writes the new entry into the cache in place, at
    the one position of ``positions`` or, with a (B,) tensor and B > 1, each
    row at its own (``_write_slots``), and attends through the absorbed
    products: scores in the input dtype, softmax in float32, probabilities
    cast back before the context, as ``repro``.

    Under a mesh (``axes``) the heads are this rank's: the columns of
    ``wq_b``, ``wk_b`` and ``wv_b`` and the rows of ``wo``, whose product
    is summed over "model" (``reduce_from``). The compressed cache is
    whole on every rank of "model" (every rank writes the same entry), or
    with ``seq_len`` (``seq_shard``) split over its positions when they
    divide there: the rank that holds a position writes it, and decode
    gathers every head's absorbed query, scores this rank's block of the
    cache and combines the softmax over the ranks (as ``_lse_attn``)."""
    B, S, _ = x.shape
    qn, qr, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    H = p.wq_b.shape[-1] // (qn + qr)
    scale = (qn + qr) ** -0.5
    g = par.group(axes, axes.model if axes is not None else ())
    seq_len = cache.get("seq_len") if (cache is not None and g is not None) else None
    marker = {} if seq_len is None else {"seq_len": seq_len}
    if positions is None:
        positions = torch.arange(S, device=x.device)
    per_slot = decode and positions.dim() == 1 and positions.shape[0] == B and B > 1

    q_nope, q_pe, c_kv, k_pe = _mla_qkv(x, p, cfg, H, axes)
    cos, sin = rope_table(positions, qr, cfg.rope_theta)
    if per_slot:  # (B, half) -> (B, 1, half)
        cos, sin = cos[:, None, :], sin[:, None, :]
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)[:, :, 0, :]  # one head, shared

    if decode:
        if cache is None or S != 1:
            raise ValueError("decode takes one token (S == 1) and a cache")
        split = g is not None and _split_cache(seq_len, g)
        n = cache["c_kv"].shape[1]
        first = g.index * n if split else 0
        t = first + torch.arange(n, device=x.device)
        if per_slot:
            if split:
                raise ValueError("per-slot decode takes a cache whole on every rank")
            ckv = _write_slots(cache["c_kv"], c_kv, positions)
            ckpe = _write_slots(cache["k_pe"], k_pe, positions)
            tmask = (t[None, :] <= positions.long()[:, None])[:, None, None, :]
        else:
            pos = positions.reshape(1).long()
            if split:
                ckv = _write_own(cache["c_kv"], pos, c_kv, first, n)
                ckpe = _write_own(cache["k_pe"], pos, k_pe, first, n)
            else:
                ckv = cache["c_kv"].index_copy_(1, pos, c_kv)
                ckpe = cache["k_pe"].index_copy_(1, pos, k_pe)
            tmask = (t <= pos)[None, None, None, :]
        # absorbed: q folded through W_UK scores against the compressed cache
        q_eff = torch.einsum("bshn,rhn->bshr", q_nope, p.wk_b.reshape(r, H, qn))
        if split:  # every head's query over this rank's block of the cache
            q_eff, q_pe = (par.gather(t_, 2, axes, axes.model) for t_ in (q_eff, q_pe))
        scores = (torch.einsum("bshr,btr->bhst", q_eff, ckv)
                  + torch.einsum("bshn,btn->bhst", q_pe, ckpe)).float() * scale
        scores = torch.where(tmask, scores, -1e30)
        if split:
            top = par.all_max(scores.amax(-1, keepdim=True), axes)
            e = torch.exp(scores - top)
            probs = (e / par.reduce_from(e.sum(-1, keepdim=True), axes)).to(x.dtype)
            ctx_c = par.reduce_from(torch.einsum("bhst,btr->bshr", probs, ckv), axes)
            ctx_c = ctx_c.narrow(2, g.index * H, H)
        else:
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx_c = torch.einsum("bhst,btr->bshr", probs, ckv)  # (B, 1, H, r)
        ctx = torch.einsum("bshr,rhv->bshv", ctx_c, p.wv_b.reshape(r, H, vd))
        out = par.reduce_from(ctx.reshape(B, S, H * vd) @ p.wo, axes)
        return out, {"c_kv": ckv, "k_pe": ckpe, **marker}

    # train / prefill: expand per position
    k_nope = (c_kv @ p.wk_b).reshape(B, S, H, qn)
    v = (c_kv @ p.wv_b).reshape(B, S, H, vd)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, qr)], dim=-1)
    if cfg.flash_attention and S >= FLASH_MIN_SEQ:
        ctx = _flash_attn(q, k, v, causal=True, scale=scale, inference=cache is not None)
    else:
        ctx = _chunked_attn(q, k, v, causal=True, q_positions=positions,
                            k_positions=positions, scale=scale,
                            remat=cfg.remat and torch.is_grad_enabled())
    out = par.reduce_from(ctx.reshape(B, S, H * vd) @ p.wo, axes)
    if cache is None:
        return out, None
    if seq_len is not None:  # seq_shard: the prompt's S positions, split where they divide
        if S % g.size == 0:
            m = S // g.size
            c_kv, k_pe = (t_.narrow(1, g.index * m, m).clone() for t_ in (c_kv, k_pe))
        marker["seq_len"] = S
    return out, {"c_kv": c_kv, "k_pe": k_pe, **marker}


def mla_cache_layout(cfg, B: int, S_max: int) -> dict:
    """``init_mla_cache``'s tensors as ``{name: (shape, dtype, fill)}``."""
    dtype = torch_dtype(cfg.dtype)
    return {"c_kv": ((B, S_max, cfg.kv_lora_rank), dtype, 0),
            "k_pe": ((B, S_max, cfg.qk_rope_dim), dtype, 0)}


def init_mla_cache(cfg, B: int, S_max: int, device=None):
    """The compressed cache: ``c_kv`` (B, S_max, kv_lora_rank) and ``k_pe``
    (B, S_max, qk_rope_dim), zeroed."""
    return make_cache(mla_cache_layout(cfg, B, S_max), device)
