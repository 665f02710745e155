"""repro_torch: the PGX.D load-balanced sort (arXiv:1611.00463) in
PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

A port of the JAX package ``repro``, module for module::

    import repro_torch
    out = repro_torch.sort(keys)                   # on "cuda"
    repro_torch.sort(keys, device="cpu")           # only when asked
    repro_torch.plan(keys, device="cpu").backend   # which backend, and why

The sort covers the sim backend, the mesh backend (SPMD over a
``torch.distributed`` ``DeviceMesh``: ``sort(x_local, where=(mesh,
axis))`` on every rank) and the out-of-core stream backend
(``repro_torch.stream``: inputs above ``SortLimits.stream_threshold``,
``where="stream"`` and iterators of arrays, with CPU tensors out): flat or
(p, n_local) keys of 8-32 bit ints and floats, and in x64 mode
(``enable_x64``) of 64-bit ones, ascending or descending, values or
argsort, with the overflow ladder; tuples of key columns (packed into one
int32 or int64 sort, or as LSD passes); the device and the host decode;
the result's views (``topk``, ``searchsorted``, ``provenance``); phase
traces and metrics (``repro_torch.obs``). For serving traffic,
``repro_torch.serve.SortServer`` is the asynchronous front end
(``submit() -> SortFuture``, batched flushes on the card, tenants,
admission control, the flight recorder and SLOs), and
``repro_torch.tune`` the opt-in cost model that the planner and the
server consult (static behaviour until it is warmed). The model tier serves dense GQA decoders
(``repro_torch.models.model.Model``, ``repro_torch.serve.engine``), with
prefill attention on a CUDA flash kernel. What neither covers raises
NotImplementedError naming the ROADMAP.md item that ports it.

The sort's names load on first use, so that importing the model tier does
not import the sort.
"""
import importlib

_EXPORTS = {
    "sort": "core.api", "plan": "core.api", "explain": "core.api",
    "OverflowPolicy": "core.overflow", "SortOverflowError": "core.overflow",
    "SortLimits": "core.planner", "SortPlan": "core.planner",
    "register_backend": "core.planner",
    "SortMeta": "core.result", "SortOutput": "core.result",
    "SortConfig": "core.splitters", "SortLibrary": "core.api",
    "encode_provenance": "core.api", "decode_provenance": "core.api",
    "load_imbalance": "core.api",
    "enable_x64": "core.x64", "x64_enabled": "core.x64", "x64_mode": "core.x64",
    "distributed_sort": "core.sample_sort", "distributed_sort_kv": "core.sample_sort",
    "sample_sort_shard": "core.sample_sort", "sample_sort_shard_kv": "core.sample_sort",
}

__all__ = [*_EXPORTS, "tune"]


def __getattr__(name: str):
    if name == "tune":
        return importlib.import_module("repro_torch.tune")
    if name not in _EXPORTS:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(f"repro_torch.{_EXPORTS[name]}"), name)
