"""Opt-in x64 mode: the gate for 64-bit keys and payloads.

Counterpart of ``repro/core/x64.py``. By default the planner refuses
int64, uint64 and float64 keys and values at the door
(``planner.check_key_dtype``), as ``repro`` does. With the mode on it
admits them: they sort through 64-bit instantiations of the bitonic
kernels, the multi-key pack budget widens from 31 to 63 bits (one int64
sort for tuples such as (id, timestamp)), and an argsort of more than
2^31 elements gets an int64 index payload.

PyTorch has 64-bit tensors without a flag, so unlike ``repro`` there is
no framework switch to flip: the mode is this library's admission switch
and nothing else. Three ways to turn it on, as in ``repro``:

  * ``REPRO_X64=1`` in the environment, read at the first check;
  * ``enable_x64()`` for the process;
  * ``SortLimits(x64=True)`` for one request; ``SortLimits(x64=False)``
    keeps a request at 32 bits under an ambient mode.

``x64_mode(on)`` is the scoped switch for tests and benchmarks: it
restores the previous state on exit.
"""
from __future__ import annotations

import contextlib
import os

# None: not set yet (the first read falls back to REPRO_X64); True/False:
# set by enable_x64() or x64_mode()
_STATE: dict = {"enabled": None}


def _env_enabled() -> bool:
    return os.environ.get("REPRO_X64", "").strip().lower() in ("1", "true", "on", "yes")


def x64_enabled() -> bool:
    """Is x64 mode on (``enable_x64``, a scoped ``x64_mode`` or
    ``REPRO_X64``)?"""
    st = _STATE["enabled"]
    if st is None:
        if not _env_enabled():
            return False
        _STATE["enabled"] = True  # the environment's opt-in, read once
        return True
    return bool(st)


def enable_x64(on: bool = True) -> None:
    """Turn x64 mode on (or off) for the process."""
    _STATE["enabled"] = bool(on)


@contextlib.contextmanager
def x64_mode(on: bool = True):
    """x64 mode on (or off) inside the block, and as it was after it."""
    prev = _STATE["enabled"]
    _STATE["enabled"] = bool(on)
    try:
        yield
    finally:
        _STATE["enabled"] = prev


def effective(limits) -> bool:
    """A request's mode: ``SortLimits.x64`` when set, else the ambient
    switch (``repro``'s ``planner._effective_x64``)."""
    if limits is not None and limits.x64 is not None:
        return bool(limits.x64)
    return x64_enabled()
