"""Serving: sort serving (``sortd``) and model serving (``engine``).

``sortd`` is the asynchronous, latency-targeted sort front end:
``SortServer.submit -> SortFuture`` with planner-driven dispatch, and
keys-only requests coalesced into one batched flush per shape bucket on
the card. ``engine`` serves the port's models (prefill, decode,
generation); ``batching`` is its continuous batcher (slots, admission
between decode steps).

Both load on first use: importing ``repro_torch.serve.engine`` loads no
sort module, and importing the package loads neither.
"""
import importlib

_SORTD = ("SortServer", "SortFuture", "QueueFullError", "RequestTooLargeError")
_BATCHING = ("ContinuousBatcher", "Request", "Completion")

__all__ = [*_SORTD, *_BATCHING]


def __getattr__(name: str):
    if name in _SORTD:
        return getattr(importlib.import_module("repro_torch.serve.sortd"), name)
    if name in _BATCHING:
        return getattr(importlib.import_module("repro_torch.serve.batching"), name)
    raise AttributeError(f"module 'repro_torch.serve' has no attribute {name!r}")
