"""Oracles for the sorting kernels, on a stable ``torch.sort``.

Counterpart of ``repro/kernels/ref.py`` (the attention oracle belongs to
the model tier and is not ported yet). The tests and ``chip_smoke.py``
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
