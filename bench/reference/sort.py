"""The plain reference of the sort cells: a stable ``torch.sort``.

``sort`` gives the sorted keys and, for ``want="order"``, the stable
sorting permutation (ties in input order, the guarantee the paper's
argsort states). ``mismatches`` counts the positions where the program's
answer differs, bit for bit for keys."""
from __future__ import annotations

import torch


def sort(x: torch.Tensor, want: str = "values"):
    s = torch.sort(x, stable=True)
    return s.values, (s.indices if want == "order" else None)


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t.long()


def mismatches(got, want: torch.Tensor) -> int:
    """Positions where ``got`` differs from ``want`` (all of them when it
    is missing or of another length)."""
    if got is None or got.shape != want.shape:
        return int(want.numel() if got is None else max(got.numel(), want.numel()))
    got = got.to(want.device)
    if got.dtype.is_floating_point != want.dtype.is_floating_point:
        return int(want.numel())
    return int((_bits(got) != _bits(want)).sum())


def control(x: torch.Tensor, want: str = "values"):
    """The reference in the program's place one step down: float keys
    sorted as bfloat16 (the precision below float32); integer keys, whose
    64 values any narrower integer holds alike, with the guarantee the
    configuration states broken instead: ties in reverse input order, an
    unstable argsort."""
    if x.dtype.is_floating_point:
        return sort(x.to(torch.bfloat16).to(x.dtype), want)
    n = x.numel()
    composite = x.long() * n + (n - 1 - torch.arange(n, device=x.device))
    order = torch.sort(composite).indices
    return x[order], (order if want == "order" else None)
