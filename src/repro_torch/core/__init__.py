"""The sort library: planner, the sim and mesh backends and the paper's six
steps (the stream backend is ``repro_torch.stream``).

The mesh sort's entry points load on first use (``torch.distributed``
stays unimported until then)::

    from repro_torch.core import distributed_sort, sample_sort_shard
"""
import importlib

_EXPORTS = ("distributed_sort", "distributed_sort_kv", "sample_sort_shard",
            "sample_sort_shard_kv")

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
    return getattr(importlib.import_module("repro_torch.core.sample_sort"), name)
