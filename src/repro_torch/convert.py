"""Carry inputs and settings from ``repro`` to the port and results back.

A sort has no weights; what crosses between the two packages is the
configuration (``SortConfig`` / ``SortLimits``, given as the plain dicts
of ``dataclasses.asdict``), the input arrays, and the output. The tests
use these to feed both packages the same thing and compare the results
as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.planner import SortLimits, as_tensor
from repro_torch.core.result import SortOutput
from repro_torch.core.splitters import SortConfig


def config_from_dict(d: dict) -> SortConfig:
    return SortConfig(**d)


def limits_from_dict(d: dict) -> SortLimits:
    return SortLimits(**d)


def to_tensor(x, device) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on ``device``."""
    return as_tensor(x).to(device)


def to_numpy(t: torch.Tensor | None) -> np.ndarray | None:
    """A tensor as a host numpy array. bfloat16, which numpy lacks, comes
    back as its uint16 bit patterns."""
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def output_to_numpy(out: SortOutput) -> dict:
    """Everything a port ``SortOutput`` carries that ``repro`` has too."""
    return {
        "keys": to_numpy(out.keys),
        "values": to_numpy(out.values),
        "counts": np.asarray(out.counts),
        "send_counts": None if out.send_counts is None else np.asarray(out.send_counts),
        "overflowed": bool(out.overflowed),
        "retries": out.meta.retries,
        "config": out.meta.config,
    }
