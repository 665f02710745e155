"""Sharding rules of the port: ``repro/sharding/rules.py``.

Only ``fit_batch_axes`` so far, which the MoE dispatch reads to find the
block of tokens a rank holds; the parameter, optimizer, batch and cache
specs come with a sharded model tier (ROADMAP.md §1 item 11).
"""
from __future__ import annotations

from repro_torch.sharding.spec import Axes


def fit_batch_axes(B: int, axes: Axes) -> tuple | None:
    """Largest prefix of the batch axes whose size product divides B;
    None when not even the first does (small-batch decode shapes
    replicate instead)."""
    out = []
    prod = 1
    for a in axes.batch:
        size = axes.mesh_shape[a] if axes.mesh_shape else 1
        if B % (prod * size) == 0:
            out.append(a)
            prod *= size
        else:
            break
    return tuple(out) if out else None
