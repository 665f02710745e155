"""repro_torch: the PGX.D load-balanced sort (arXiv:1611.00463) in
PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

A port of the JAX package ``repro``, module for module::

    import repro_torch
    out = repro_torch.sort(keys)                   # on "cuda"
    repro_torch.sort(keys, device="cpu")           # only when asked
    repro_torch.plan(keys, device="cpu").backend   # which backend, and why

This slice covers the sim backend: flat or (p, n_local) keys of 8-32
bit ints and floats, ascending or descending, values or argsort, with
the overflow ladder. What it does not cover raises NotImplementedError
naming the ROADMAP.md item that ports it.
"""
from repro_torch.core.api import explain, plan, sort
from repro_torch.core.overflow import OverflowPolicy, SortOverflowError
from repro_torch.core.planner import SortLimits, SortPlan, register_backend
from repro_torch.core.result import SortMeta, SortOutput
from repro_torch.core.splitters import SortConfig

__all__ = [
    "sort", "plan", "explain",
    "SortOutput", "SortMeta", "SortPlan", "SortLimits", "SortConfig",
    "OverflowPolicy", "SortOverflowError", "register_backend",
]
