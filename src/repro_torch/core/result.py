"""``SortOutput``: the result type of ``repro_torch.sort``.

Counterpart of ``repro/core/result.py``. The sorted keys and payload are
tensors on the sort's device, in the caller's dtypes; the per-shard
diagnostics (``counts``, ``send_counts``) are small host numpy arrays, as
in ``repro``. ``topk``, ``searchsorted``, ``provenance`` and ``chunks``
are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class SortMeta:
    """Backend and plan metadata recorded on every SortOutput.

    config: the SortConfig actually used, after any capacity retries.
    retries: capacity-ladder steps taken by the overflow policy.
    order: "asc" | "desc", or a tuple with one flag per key.
    n_keys: key columns of the request (1 for a single key).
    n_local: per-processor row length when the input arrived in the
      (p, n_local) layout.
    dtype: the key dtype (the first column's for a multi-key sort).
    multikey: how a multi-key request ran, "packed" or "lsd"; None for a
      single key. ``plan.packspec`` holds a packed run's recipe.
    """

    backend: str
    plan: Any = None
    config: Any = None
    retries: int = 0
    n: int = 0
    want: str = "values"
    order: Any = "asc"
    n_keys: int = 1
    n_local: int | None = None
    dtype: Any = None
    multikey: str | None = None


class SortOutput:
    """Sorted result.

    keys:        flat sorted keys (a tensor on the sort's device; CPU
                 tensors under decode="host"), a tuple of them for a
                 multi-key sort.
    values:      payload in sorted-key order: the caller's values, or the
                 original flat indices when ``want="order"``; else None.
    counts:      per-shard sizes (numpy), pads removed.
    send_counts: (p, p) per (source, destination) bucket sizes (numpy).
    overflowed:  True iff a bucket overflowed (only when the policy does
                 not raise).
    raw:         the backend's padded global-view result.
    """

    def __init__(self, meta: SortMeta, *, keys: torch.Tensor, values=None,
                 counts=None, overflowed: bool = False, send_counts=None,
                 raw: Any = None):
        self.meta = meta
        self.keys = keys
        self.values = values
        self.counts = counts
        self.overflowed = overflowed
        self.send_counts = send_counts
        self.raw = raw

    def order(self) -> torch.Tensor:
        """The sorting permutation (``want="order"`` results)."""
        if self.meta.want != "order":
            raise ValueError('order() requires sort(..., want="order")')
        return self.values

    def imbalance(self) -> float:
        """max/mean shard size; 1.0 is perfect balance (paper Table II)."""
        if self.counts is None:
            return float("nan")
        counts = np.asarray(self.counts, np.float64)
        if counts.size == 0 or counts.sum() == 0:
            return 1.0
        return float(counts.max() / max(counts.mean(), 1e-12))

    def __len__(self) -> int:
        return self.meta.n

    def __repr__(self) -> str:
        first = self.keys[0] if isinstance(self.keys, tuple) else self.keys
        return (
            f"SortOutput(n={self.meta.n}, backend={self.meta.backend!r}, "
            f"want={self.meta.want!r}, order={self.meta.order!r}, "
            f"overflowed={self.overflowed}, device={first.device})"
        )
