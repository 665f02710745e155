"""Recurrent mixers: RG-LRU (Griffin / recurrentgemma) and Mamba1
(falcon-mamba).

The port of ``repro/models/recurrent.py``. Both mixers are diagonal
linear recurrences h_t = a_t * h_{t-1} + b_t. Prefill splits the sequence
into chunks of ``SCAN_CHUNK`` rows: across chunks a Python loop carries
the boundary state, within a chunk a log-depth (Hillis-Steele) scan over
the chunk axis combines (a, b) pairs in ceil(log2(C)) elementwise steps,
8 for a chunk of 256. ``repro`` runs the same split with
``jax.lax.associative_scan`` inside a ``lax.scan``; the two associate the
products in other orders, which is the only difference in float32. Decode
advances the recurrence one step from the carried state.

The scan is plain PyTorch: ``repro``'s is plain ``jnp`` too (no Pallas
kernel lies on this path).

Under a mesh (``axes``) both mixers are tensor-parallel over "model"
along their width, as ``repro``'s partition specs put them, and the scan
stays local: a recurrence is elementwise over the width.

  * RG-LRU: ``wx``, ``wg``, ``conv`` and ``lam`` hold this rank's slice of
    the width, ``wa`` and ``wi`` its nb / M of the nb gate blocks, which
    are exactly the blocks of that slice (M must divide nb); ``wo`` holds
    its rows and the output is summed over "model" (``reduce_from``).
  * Mamba: ``conv``, ``dt_proj``, ``dt_bias``, ``A_log`` and ``D`` hold
    this rank's slice of di; ``x_proj`` and ``out_proj`` its rows. The
    (B, S, dt_rank + 2 N) product of ``x_proj`` is summed over "model"
    before dt, B and C are taken from it, and enters the rank's part of
    the scan through ``copy_to`` (its gradient is the sum of the ranks'
    parts). ``in_proj`` (d, 2 di) keeps ``repro``'s spec (None, "model"):
    a rank holds one contiguous block of its 2 di columns, so with two
    ranks rank 0 holds all of x's half and rank 1 all of z's. The port
    keeps that layout (so parameters, checkpoints and ``convert`` need no
    other) and re-splits the product instead: one all-to-all over "model"
    gives each rank its slice of x and its slice of z
    (``parallel.split_halves``; backward, the inverse).

The ``conv`` and ``h`` caches hold this rank's slice of the width
(``rules.cache_specs``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _const, _init, _s4d_log, make_cache, torch_dtype
from repro_torch.sharding import parallel as par

SCAN_CHUNK = 256
_RGLRU_C = 8.0


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ------------------------------------------------------------------ scan


def _chunks(S: int) -> list[tuple[int, int]]:
    """(start, stop) of each scan chunk: the whole sequence when it fits
    one chunk; longer sequences must be a multiple of SCAN_CHUNK, as in
    ``repro`` (AssertionError)."""
    if S <= SCAN_CHUNK:
        return [(0, S)]
    if S % SCAN_CHUNK:
        raise AssertionError(f"seq {S} % {SCAN_CHUNK} != 0")
    return [(c, c + SCAN_CHUNK) for c in range(0, S, SCAN_CHUNK)]


def _assoc_scan(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t over axis 1 (the chunk), h0 the state
    before it (or None). a, b: (B, C, ...). Returns (h (B, C, ...),
    h_last). Step s combines each row t >= s with row t - s: (a, b)_t <-
    (a_{t-s} a_t, a_t b_{t-s} + b_t). h_last is a copy: a view would keep
    the chunk's h alive in the cache it is carried into."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    C = a.shape[1]
    s = 1
    while s < C:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:], b[:, :-s])], dim=1)
        if 2 * s < C:  # the last step needs no products of a
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b, b[:, -1].clone()


def _chunked_linear_scan(a, b, h0):
    """The recurrence over the whole sequence, chunk after chunk. a, b:
    (B, S, ...); h0: (B, ...) or None. Returns (h (B, S, ...), h_last)."""
    spans = _chunks(a.shape[1])
    if len(spans) > 1 and h0 is None:
        h0 = a.new_zeros((a.shape[0],) + a.shape[2:])
    hs = []
    for lo, hi in spans:
        h, h0 = _assoc_scan(a[:, lo:hi], b[:, lo:hi], h0)
        hs.append(h)
    return (hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)), h0


def _causal_conv(x, w, state=None):
    """Depthwise causal conv along the sequence. x: (B, S, D), w: (K, D);
    state: (B, K-1, D), the carried history. Returns (y (B, S, D),
    new_state (B, K-1, D)). The taps are summed left to right from 0 in
    x's dtype, as ``repro``'s ``sum``, so bfloat16 rounds as it does. The
    new state is a copy, not a view that would keep xp alive in the
    cache."""
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return y, xp[:, -(K - 1):].clone()


# ---------------------------------------------------------------- RG-LRU


class RGLRU(nn.Module):
    """``init_rglru``: ``wx``/``wg`` (d, w), ``conv`` (4, w), the
    block-diagonal gates ``wa``/``wi`` (n_heads, w / n_heads, w / n_heads),
    float32 ``lam`` (2.0) and ``wo`` (w, d), each at ``repro``'s scale.
    ``axes`` is taken for the mixers' common signature: the shapes do not
    change (a sharded model's blocks are cut by ``parallel.shard_leaf``,
    which refuses an nb that "model" does not divide)."""

    def __init__(self, cfg, gen, device=None, axes=None):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        d, w = cfg.d_model, cfg.lru_width
        nb = max(1, cfg.n_heads)
        bs = w // nb
        self.wx = _init(gen, (d, w), d ** -0.5, dtype, device)
        self.wg = _init(gen, (d, w), d ** -0.5, dtype, device)
        self.conv = _init(gen, (4, w), 0.1, dtype, device)
        self.wa = _init(gen, (nb, bs, bs), bs ** -0.5, dtype, device)
        self.wi = _init(gen, (nb, bs, bs), bs ** -0.5, dtype, device)
        self.lam = _const(2.0, (w,), torch.float32, device)
        self.wo = _init(gen, (w, d), w ** -0.5, dtype, device)


def _block_diag(u, w):
    """u: (B, S, width); w: (nb, bs, bs), a block-diagonal matmul."""
    B, S, width = u.shape
    nb, bs, _ = w.shape
    return torch.einsum("bsnv,nvw->bsnw", u.reshape(B, S, nb, bs), w).reshape(B, S, width)


def _rglru_coeffs(u, p: RGLRU):
    """Per-step gates -> (a, b) of the diagonal recurrence, in float32."""
    uf = u.float()
    r = torch.sigmoid(_block_diag(uf, p.wa.float()))
    i = torch.sigmoid(_block_diag(uf, p.wi.float()))
    log_a = -_RGLRU_C * _softplus(p.lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * uf)
    return a, b


def rglru_forward(x, p: RGLRU, cfg, *, cache=None, decode: bool = False, axes=None):
    """Griffin's recurrent block: [Wx -> conv -> RG-LRU] * gelu(Wg) -> Wo.
    Returns (out, new_cache); the cache is {"conv", "h"} when one was
    given. ``axes``: this rank's slice of the width (module docstring)."""
    B, S, _ = x.shape
    x = par.copy_to(x, axes)
    u = x @ p.wx
    gate = F.gelu(x @ p.wg, approximate="tanh")  # jax.nn.gelu's default
    u, new_conv = _causal_conv(u, p.conv, cache.get("conv") if cache else None)
    a, b = _rglru_coeffs(u, p)
    h0 = cache.get("h") if cache else None
    if decode:
        if S != 1:
            raise ValueError("decode takes one token (S == 1)")
        if h0 is None:
            h0 = a.new_zeros((B, u.shape[-1]))
        h_last = a[:, 0] * h0 + b[:, 0]
        h = h_last[:, None]
    else:
        h, h_last = _chunked_linear_scan(a, b, h0)
    out = par.reduce_from((h.to(x.dtype) * gate) @ p.wo, axes)
    return out, ({"conv": new_conv, "h": h_last} if cache is not None else None)


def rglru_cache_layout(cfg, B: int) -> dict:
    """``init_rglru_cache``'s tensors as ``{name: (shape, dtype, fill)}``."""
    w = cfg.lru_width
    return {"conv": ((B, 3, w), torch_dtype(cfg.dtype), 0), "h": ((B, w), torch.float32, 0)}


def init_rglru_cache(cfg, B: int, device=None) -> dict:
    """conv (B, 3, lru_width) in the model dtype, h (B, lru_width) float32."""
    return make_cache(rglru_cache_layout(cfg, B), device)


# ----------------------------------------------------------------- Mamba


class Mamba(nn.Module):
    """``init_mamba``: ``in_proj`` (d, 2 di), ``conv`` (ssm_conv, di),
    ``x_proj`` (di, dt_rank + 2 N), ``dt_proj`` (dt_rank, di), float32
    ``dt_bias`` (zeros), ``A_log`` (log 1..N on every row, S4D-real) and
    ``D`` (ones), and ``out_proj`` (di, d); di = ssm_expand x d_model,
    N = ssm_state, dt_rank = max(1, d_model // 16). ``axes`` is taken for
    the mixers' common signature: the shapes do not change."""

    def __init__(self, cfg, gen, device=None, axes=None):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        d = cfg.d_model
        di = cfg.ssm_expand * d
        N = cfg.ssm_state
        dt_rank = max(1, d // 16)
        self.in_proj = _init(gen, (d, 2 * di), d ** -0.5, dtype, device)
        self.conv = _init(gen, (cfg.ssm_conv, di), 0.1, dtype, device)
        self.x_proj = _init(gen, (di, dt_rank + 2 * N), di ** -0.5, dtype, device)
        self.dt_proj = _init(gen, (dt_rank, di), dt_rank ** -0.5, dtype, device)
        self.dt_bias = _const(0.0, (di,), torch.float32, device)
        self.A_log = _s4d_log((di, N), device)
        self.D = _const(1.0, (di,), torch.float32, device)
        self.out_proj = _init(gen, (di, d), di ** -0.5, dtype, device)


def mamba_forward(x, p: Mamba, cfg, *, cache=None, decode: bool = False, axes=None):
    """Mamba1's selective SSM (diagonal, real A). Returns (out, new_cache).

    dt is a bf16 product plus the float32 ``dt_bias``, so float32, as in
    ``repro``; a, b, h and y are float32 and y is cast to the model dtype
    before the silu(z) gate. ``repro`` materialises a, b and h over the
    whole sequence, (B, S, di, N) each; here prefill forms a and b, scans
    and reduces y = (h C).sum(-1) one SCAN_CHUNK of rows at a time, so the
    live set is (B, SCAN_CHUNK, di, N), with each element's arithmetic
    unchanged. ``axes``: this rank's slice of di (module docstring)."""
    B, S, _ = x.shape
    di = p.in_proj.shape[-1] // 2
    N = cfg.ssm_state
    dt_rank = p.dt_proj.shape[0]

    xz = par.split_halves(par.copy_to(x, axes) @ p.in_proj, axes)
    xb, z = xz[..., :di], xz[..., di:]
    xc, new_conv = _causal_conv(xb, p.conv, cache.get("conv") if cache else None)
    xc = F.silu(xc)

    proj = par.copy_to(par.reduce_from(xc @ p.x_proj, axes), axes)  # (B, S, dt_rank + 2N)
    dt = _softplus(proj[..., :dt_rank] @ p.dt_proj + p.dt_bias).float()  # (B, S, di)
    Bs = proj[..., dt_rank:dt_rank + N].float()  # (B, S, N)
    Cs = proj[..., dt_rank + N:].float()  # (B, S, N)
    A = -torch.exp(p.A_log)  # (di, N)
    xf = xc.float()

    h0 = cache.get("h") if cache else None
    if decode:
        if S != 1:
            raise ValueError("decode takes one token (S == 1)")
        if h0 is None:
            h0 = xf.new_zeros((B, di, N))
        a = torch.exp(dt[:, 0, :, None] * A)
        b = dt[:, 0, :, None] * Bs[:, 0, None, :] * xf[:, 0, :, None]
        h0 = a * h0 + b
        y = (h0[:, None] * Cs[:, :, None, :]).sum(-1)
    else:
        spans = _chunks(S)
        if len(spans) > 1 and h0 is None:
            h0 = xf.new_zeros((B, di, N))
        ys = []
        for lo, hi in spans:
            dtc = dt[:, lo:hi, :, None]
            a = torch.exp(dtc * A)  # (B, C, di, N)
            b = dtc * Bs[:, lo:hi, None, :] * xf[:, lo:hi, :, None]
            h, h0 = _assoc_scan(a, b, h0)
            ys.append((h * Cs[:, lo:hi, None, :]).sum(-1))  # (B, C, di)
            del a, b, h
        y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    y = y + p.D * xf
    out = par.reduce_from((y.to(x.dtype) * F.silu(z)) @ p.out_proj, axes)
    return out, ({"conv": new_conv, "h": h0} if cache is not None else None)


def mamba_cache_layout(cfg, B: int) -> dict:
    """``init_mamba_cache``'s tensors as ``{name: (shape, dtype, fill)}``."""
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": ((B, cfg.ssm_conv - 1, di), torch_dtype(cfg.dtype), 0),
            "h": ((B, di, cfg.ssm_state), torch.float32, 0)}


def init_mamba_cache(cfg, B: int, device=None) -> dict:
    """conv (B, ssm_conv - 1, di) in the model dtype, h (B, di, ssm_state)
    float32."""
    return make_cache(mamba_cache_layout(cfg, B), device)
