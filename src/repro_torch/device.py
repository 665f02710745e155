"""The port's device rule.

Every entry point takes ``device=None``, which means ``"cuda"``. Without a
CUDA device the call raises and says how to ask for the CPU; it never
runs on the CPU unless the caller passed ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device a sort runs on: ``device``, or ``"cuda"`` when None."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev.type!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available here; pass device='cpu' to run the plain PyTorch "
            "path on the CPU"
        )
    return dev
