"""Oracles for the kernels: the sorting ones on a stable ``torch.sort``,
and plain attention for the flash kernel.

Counterpart of ``repro/kernels/ref.py``. The tests and ``chip_smoke.py``
hold the kernels and ``ops`` against these.
"""
from __future__ import annotations

import torch


def sort_rows_ref(keys: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """Sort each row of ``keys`` (R, N) independently."""
    out = torch.sort(keys, dim=-1, stable=True).values
    return out.flip(-1) if descending else out


def sort_rows_kv_ref(keys, values, descending: bool = False, stable: bool = True):
    """Stable key/value row sort oracle."""
    order = torch.sort(keys, dim=-1, stable=stable, descending=descending).indices
    return torch.gather(keys, -1, order), torch.gather(values, -1, order)


def merge_rows_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two row-wise sorted arrays; ties keep ``a`` first."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1, stable=True).values


def merge_rows_kv_ref(ak, av, bk, bv):
    keys = torch.cat([ak, bk], dim=-1)
    vals = torch.cat([av, bv], dim=-1)
    order = torch.sort(keys, dim=-1, stable=True).indices
    return torch.gather(keys, -1, order), torch.gather(vals, -1, order)


def attention_ref(q, k, v, causal: bool = True, scale=None):
    """Plain attention oracle for the flash kernel. q: (B,S,H,dh),
    k/v: (B,T,KV,dh), GQA via head grouping."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, S, KV, rep, dh)
    s = torch.einsum("bskrd,btkd->bkrst", qg, k).float() * scale
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(T, device=q.device)[None, :]
        s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", p, v)
    return out.reshape(B, S, H, dh)
