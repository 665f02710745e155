"""Sort API: ``sort``, ``plan`` and ``explain``.

Counterpart of the unified front end of ``repro/core/api.py``::

    import repro_torch
    out = repro_torch.sort(keys)             # -> SortOutput, on "cuda"
    out.keys                                 # sorted keys, a device tensor
    repro_torch.sort(keys, device="cpu")     # the plain path, on the CPU

keys:   a flat tensor or numpy array, or a (p, n_local) grid whose rows
        are the shards.
values: optional payload that rides the sort.
order:  "asc" | "desc".
want:   "values" (sorted keys [+ payload]) | "order" (the stable sorting
        permutation).
where:  backend override; only "sim" is ported.
limits: ``SortLimits``; config: ``SortConfig`` (the paper's defaults).
device: None means "cuda", which must exist; "cpu" on request only.
"""
from __future__ import annotations

from repro_torch.core import planner
from repro_torch.core.planner import SortLimits, SortPlan
from repro_torch.core.result import SortOutput
from repro_torch.core.splitters import SortConfig


def sort(keys, values=None, *, order="asc", want="values", where=None,
         limits: SortLimits | None = None, config: SortConfig | None = None,
         investigator: bool = True, device=None) -> SortOutput:
    """Sort ``keys`` (see the module docstring)."""
    return planner.execute(
        keys, values, order=order, want=want, where=where, limits=limits,
        config=config, investigator=investigator, device=device,
    )


def plan(keys, values=None, *, order="asc", want="values", where=None,
         limits: SortLimits | None = None, config: SortConfig | None = None,
         investigator: bool = True, device=None) -> SortPlan:
    """The backend the planner will use for this request, and why."""
    return planner.make_plan(
        keys, values, order=order, want=want, where=where, limits=limits,
        config=config, investigator=investigator, device=device,
    )


def explain(keys, values=None, **kwargs) -> str:
    """Human-readable rendering of ``plan(...)``."""
    return plan(keys, values, **kwargs).explain()
