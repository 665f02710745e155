"""Shared neural layers: norms, rotary embeddings, MLPs, embeddings.

The port of ``repro/models/layers.py``. Parameters live in ``nn.Module``s
whose attributes are named as the JAX pytree's leaves (``scale``, ``wi``,
``table``, ...) and kept in the JAX layout (a projection is ``x @ w`` with
``w`` of shape (d_in, d_out)), so ``convert.params_from_jax`` maps one onto
the other by name. The ``apply_*`` functions take such a module where the
JAX ones take a dict. Weights are drawn as ``_init`` draws them, a normal
times a scale, then cast: the same distribution, not the same bits.
Compute dtype is cfg.dtype; norm statistics are taken in float32.
Parameters are trainable (``requires_grad``); serving runs under
``torch.no_grad()`` (``serve/engine.py``), so it records no graph.

Under a mesh (``axes``) the MLP is tensor-parallel, Megatron's way: ``wi``,
``wg`` and ``bi`` hold this rank's columns of the hidden width, ``wo`` its
rows, and the partial products are summed over "model" (``reduce_from``)
before ``bo``. The embedding is vocab-parallel: a rank holds a block of
the table's rows, looks up the ids that fall in it, zeros the others, and
the blocks' lookups are summed over "model": exactly one rank contributes
to each id, so the sum is the one-rank lookup bit for bit.

A sharded model draws its parameters whole, one leaf at a time and in the
one-rank model's order, and keeps its block of each (``model.Model``):
inside ``recording()`` (per thread), ``_init``, ``_const`` and
``_s4d_log`` make parameters on the meta device and note in creation order how to draw each.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import parallel as par

_LOCAL = threading.local()


@contextlib.contextmanager
def recording():
    """Within it, on this thread, ``_init``, ``_const`` and ``_s4d_log``
    draw nothing: each returns a meta parameter and appends (parameter,
    "randn" | "full" | "s4d", scale | value | None) to the list this
    yields."""
    prev, _LOCAL.drawn = getattr(_LOCAL, "drawn", None), []
    try:
        yield _LOCAL.drawn
    finally:
        _LOCAL.drawn = prev


def _recorded(shape, dtype, kind: str, arg) -> nn.Parameter | None:
    """Inside ``recording()``: a meta parameter, noted; else None."""
    drawn = getattr(_LOCAL, "drawn", None)
    if drawn is None:
        return None
    p = nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"))
    drawn.append((p, kind, arg))
    return p


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def draw(gen, kind: str, arg, shape, dtype, device) -> torch.Tensor:
    """What ``_init`` ("randn", scale), ``_const`` ("full", value) or
    ``_s4d_log`` ("s4d") makes."""
    if kind == "randn":  # scaled in place: a leaf's float32 draw is its largest copy
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(arg)
        return w.to(dtype)
    if kind == "s4d":
        a = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(shape).clone().to(dtype)
    return torch.full(shape, arg, dtype=dtype, device=device)


def _init(gen, shape, scale, dtype, device) -> nn.Parameter:
    p = _recorded(shape, dtype, "randn", scale)
    return p if p is not None else nn.Parameter(draw(gen, "randn", scale, shape, dtype, device))


def _const(value: float, shape, dtype, device) -> nn.Parameter:
    p = _recorded(shape, dtype, "full", value)
    return p if p is not None else nn.Parameter(draw(None, "full", value, shape, dtype, device))


def _s4d_log(shape, device) -> nn.Parameter:
    """float32 log(1..N) on every row of ``shape`` (..., N): Mamba's
    S4D-real ``A_log``."""
    p = _recorded(shape, torch.float32, "s4d", None)
    return p if p is not None else nn.Parameter(draw(None, "s4d", None, shape, torch.float32,
                                                     device))


# ------------------------------------------------------------------ norms


class Norm(nn.Module):
    """``init_norm``: a float32 ``scale`` (ones), and ``bias`` (zeros) for
    layernorm."""

    def __init__(self, cfg, dim: int, device=None):
        super().__init__()
        self.scale = _const(1.0, (dim,), torch.float32, device)
        self.bias = _const(0.0, (dim,), torch.float32, device) if cfg.norm == "layernorm" else None


def apply_norm(x, p: Norm, cfg):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * p.scale + p.bias
    else:  # rmsnorm
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * p.scale
    return out.to(x.dtype)


def rms_norm_simple(x, scale, eps=1e-6):
    """Per-head RMS norm (qk_norm)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ------------------------------------------------------------------- rope


def rope_table(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """cos/sin tables for rotary embedding, float32, of shape
    positions.shape + (dim/2,)."""
    half = dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2). The product is
    taken in float32 (JAX promotes bf16 x f32 the same way), then cast
    back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embed(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embeddings at ``positions``, float32 (positions, dim)."""
    pos = positions.float()[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=positions.device)[None, :]
    ang = pos / (10000 ** (2 * i / dim))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -------------------------------------------------------------------- mlp


class MLP(nn.Module):
    """``init_mlp``: ``wi`` (and ``wg`` when gated) (d_in, d_ff), ``wo``
    (d_ff, d_in), and zero biases ``bi``/``bo`` when cfg.mlp_bias."""

    def __init__(self, cfg, d_in: int, d_ff: int, gen, device=None):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        self.wi = _init(gen, (d_in, d_ff), d_in ** -0.5, dtype, device)
        self.wg = _init(gen, (d_in, d_ff), d_in ** -0.5, dtype, device) if cfg.mlp_gated else None
        self.wo = _init(gen, (d_ff, d_in), d_ff ** -0.5, dtype, device)
        self.bi = _const(0.0, (d_ff,), dtype, device) if cfg.mlp_bias else None
        self.bo = _const(0.0, (d_in,), dtype, device) if cfg.mlp_bias else None


def _act(x, name: str):
    if name == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    return F.silu(x)


def apply_mlp(x, p: MLP, cfg, axes=None):
    x = par.copy_to(x, axes)
    h = x @ p.wi
    if p.bi is not None:
        h = h + p.bi
    if p.wg is not None:
        h = _act(x @ p.wg, cfg.act) * h
    else:
        h = _act(h, cfg.act)
    out = par.reduce_from(h @ p.wo, axes)
    if p.bo is not None:
        out = out + p.bo
    return out


# ------------------------------------------------------------- embeddings


class Embed(nn.Module):
    """``init_embed``: ``table`` (vocab_padded, d_model)."""

    def __init__(self, cfg, vocab_padded: int, gen, device=None):
        super().__init__()
        self.table = _init(gen, (vocab_padded, cfg.d_model), 0.02, torch_dtype(cfg.dtype), device)


def embed_tokens(ids, p: Embed, axes=None):
    g = par.group(axes, axes.model) if axes is not None else None
    if g is None:
        return p.table[ids]
    rows = p.table.shape[0]
    local = ids.long() - g.index * rows
    mine = (local >= 0) & (local < rows)
    out = torch.where(mine[..., None], p.table[local.clamp(0, rows - 1)], 0)
    return par.reduce_from(out, axes)
