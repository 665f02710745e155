"""The plain reference of a language-model configuration with attention
and dense or MoE feed-forward layers (deepseek-moe-16b): the logits of
the last position of each prompt of each request, in float32, with TF32
off.

It follows the architecture as the configuration states it, written
from the papers, not from the program: pre-norm blocks (RMSNorm, eps
``norm_eps``, float32 scales); multi-head causal attention with rotary
embeddings on the two halves of each head (theta ``rope_theta``), scores
scaled by 1/sqrt(d_head); a SwiGLU MLP (silu(x Wg) * (x Wi)) Wo for the
dense layers; for the MoE layers a float32 router, softmax over the
experts, the top ``moe_topk`` by a stable descending order (ties to the
lower index), their weights renormalised to sum to 1 where the
configuration's ``norm_topk_prob`` says so, each expert a SwiGLU of
``d_expert``, the ``n_shared_experts`` as one SwiGLU of their summed
width added for every token; an untied head. A configuration with a
``moe_capacity_factor`` caps each expert at ``int(T * K // E *
moe_capacity_factor) + 1`` assignments of a request's T tokens (all its
prompts together), keeping the assignments of the earliest (token, rank)
slots; without one no assignment is dropped.

Everything runs layer by layer: each layer's weights are made again from
the seed (``benchlib.lmweights``) and dropped after it, attention a few
heads at a time, so that it fits on the card after the program has
freed its state. ``rounding`` rounds each tensor where the program would
hold it in its served type (the control puts a lower precision there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchlib import lmweights

HEADS_AT_ONCE = 4


def _identity(t):
    return t


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, positions, theta):
    """x (S, H, dh): rotate the pairs (x1_i, x2_i) of the two halves."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * freqs  # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(h, w, cfg, p, q):
    """h (S, d) -> (S, d): causal multi-head attention of one prompt."""
    S, d = h.shape
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg.get("d_head") or d // H
    pos = torch.arange(S, device=h.device)
    qh = _rope(q(h @ w[p + "mix.wq"]).reshape(S, H, dh), pos, cfg["rope_theta"])
    kh = _rope(q(h @ w[p + "mix.wk"]).reshape(S, KV, dh), pos, cfg["rope_theta"])
    vh = q(h @ w[p + "mix.wv"]).reshape(S, KV, dh)
    rep = H // KV
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).triu_(1)
    ctx = torch.empty(S, H, dh, dtype=torch.float32, device=h.device)
    for h0 in range(0, H, HEADS_AT_ONCE):
        hs = range(h0, min(H, h0 + HEADS_AT_ONCE))
        qs = qh[:, hs.start:hs.stop].transpose(0, 1)  # (h, S, dh)
        ks = kh[:, [i // rep for i in hs]].transpose(0, 1)
        vs = vh[:, [i // rep for i in hs]].transpose(0, 1)
        s = (qs @ ks.transpose(1, 2)) * dh ** -0.5
        s.masked_fill_(mask, float("-inf"))
        ctx[:, hs.start:hs.stop] = (torch.softmax(s, dim=-1) @ vs).transpose(0, 1)
        del s
    return q(q(ctx.reshape(S, H * dh)) @ w[p + "mix.wo"])


def _swiglu(x, wi, wg, wo, q):
    return q(q(F.silu(x @ wg) * (x @ wi)) @ wo)


def _moe(h, w, cfg, p, q):
    """h (T, d) -> (T, d): the routed experts of one batch, and the shared."""
    T, d = h.shape
    E, K = cfg["n_experts"], cfg["moe_topk"]
    probs = torch.softmax(h @ w[p + "moe.router"], dim=-1)
    wts, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts, ids = wts[:, :K], ids[:, :K]
    if cfg["norm_topk_prob"]:
        wts = wts / wts.sum(-1, keepdim=True).clamp_min(1e-9)
    factor = cfg.get("moe_capacity_factor")
    cap = T if factor is None else max(1, int(T * K // E * factor) + 1)
    experts = ids.reshape(-1)  # the expert of slot t * K + k
    out = torch.zeros(T, d, dtype=torch.float32, device=h.device)
    order = torch.sort(experts, stable=True).indices  # the slots by expert, then slot
    counts = torch.bincount(experts, minlength=E).tolist()
    at = 0
    for e in range(E):
        kept = order[at:at + min(counts[e], cap)]
        at += counts[e]
        if kept.numel() == 0:
            continue
        tok = kept // K
        y = _swiglu(h[tok], w[p + "moe.wi"][e], w[p + "moe.wg"][e], w[p + "moe.wo"][e], q)
        out.index_add_(0, tok, y * wts.reshape(-1)[kept, None])
    out = q(out)
    if cfg["n_shared_experts"]:
        out = out + _swiglu(h, w[p + "shared.wi"], w[p + "shared.wg"], w[p + "shared.wo"], q)
    return q(out)


def _weights(cfg, seed, index, device, q):
    """Group ``index``, made again from the seed, in float32 (the
    matrices through ``q``)."""
    out = {}
    for name, t in lmweights.make_group(cfg, seed, index, device).items():
        t = t.float()
        out[name] = q(t) if t.dim() >= 2 and not name.endswith("router") else t
    return out


@torch.no_grad()
def last_logits(cfg: dict, seed: int, tokens: torch.Tensor, device, rounding=None):
    """(R, B, vocab) float32 logits of the last position of each prompt of
    the R requests in ``tokens`` (R, B, S). Attention runs prompt by
    prompt; the feed-forward layers take a request's B * S tokens as one
    batch, as the served model does."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    q = rounding or _identity
    eps = cfg["norm_eps"]
    try:
        head = _weights(cfg, seed, 0, device, q)
        R, B, S = tokens.shape
        x = q(head["embed.table"][tokens.to(device)])  # (R, B, S, d)
        final, lm_head = head["final_norm.scale"], head["lm_head.w"]
        del head
        for i, (_, ffn) in enumerate(lmweights.layer_specs(cfg)):
            w = _weights(cfg, seed, i + 1, device, q)
            p = f"layers.{i}."
            for r in range(R):
                for b in range(B):
                    h = q(_rms(x[r, b], w[p + "ln1.scale"], eps))
                    x[r, b] = q(x[r, b] + _attention(h, w, cfg, p, q))
                xr = x[r].reshape(B * S, -1)
                h = q(_rms(xr, w[p + "ln2.scale"], eps))
                if ffn == "dense":
                    f = _swiglu(h, w[p + "mlp.wi"], w[p + "mlp.wg"], w[p + "mlp.wo"], q)
                else:
                    f = _moe(h, w, cfg, p, q)
                x[r] = q(xr + f).reshape(B, S, -1)
            del w
        last = q(_rms(x[:, :, -1], final, eps))
        return (last @ lm_head)[..., :cfg["vocab"]]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def fp8_rounding(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale a tensor (its largest magnitude to 448):
    the control's precision, the step below bfloat16."""
    amax = t.abs().max().clamp_min(1e-30)
    s = amax / 448.0
    return (t / s).clamp_(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32) * s
