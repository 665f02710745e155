"""Optional ``torch.profiler`` ranges on the stream's hot path.

Counterpart of ``repro/obs/profiling.py``. Wall-time spans
(``repro_torch.obs.tracing``) answer "which phase is slow"; the profiler
answers "what is that phase doing on the device". When enabled, the
stream's chunk staging runs inside ``torch.profiler.record_function`` so
a ``torch.profiler`` trace (``tools/profile_sort.py``) shows the same
names beside the kernels and copies they issue.

Disabled by default: ``record_function`` costs a host-side event even
without a capture running, so the hooks are a no-op unless
``REPRO_PROFILE=1`` is set in the environment or ``set_profiling(True)``
is called.
"""
from __future__ import annotations

import contextlib
import os

_profiling = os.environ.get("REPRO_PROFILE", "") == "1"


def set_profiling(flag: bool) -> None:
    global _profiling
    _profiling = bool(flag)


def profiling_enabled() -> bool:
    return _profiling


@contextlib.contextmanager
def annotate(name: str):
    """``torch.profiler.record_function(name)`` when profiling is on,
    otherwise a no-op."""
    if not _profiling:
        yield
        return
    import torch.profiler

    with torch.profiler.record_function(name):
        yield
