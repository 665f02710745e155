"""Run every case of tests/torch_x64_cases.py through ``repro`` in x64 mode
and save what comes out, for tests/test_torch_x64.py.

    REPRO_X64=1 JAX_PLATFORMS=cpu python tests/torch_x64_reference.py OUT.npz

``repro``'s x64 mode flips jax's process-wide ``jax_enable_x64`` flag
(its scoped ``x64_mode`` does not work on jax 0.9), so the reference runs
in a process of its own: under pytest-xdist the flag would otherwise leak
into the next test file on the same worker. Per case the npz holds
``<name>/keys<i>``, ``/values``, ``/counts``, ``/reasons`` (the plan's,
one per line) or ``/error`` (the exception's type and text); and the
provenance helpers' answers under ``provenance/...``.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_x64_cases  # noqa: E402

import repro  # noqa: E402
from repro.core import api as core_api  # noqa: E402
from repro.core import keyenc  # noqa: E402


def _error(e: Exception) -> np.ndarray:
    return np.array(f"{type(e).__name__}: {e}")


def run_case(name: str, case: dict, out: dict) -> None:
    limits = repro.SortLimits(**case["limits"])
    config = repro.SortConfig(**case["config"])
    prev = keyenc.PROVENANCE_INT32_CAP
    if case["cap"] is not None:
        keyenc.PROVENANCE_INT32_CAP = case["cap"]
    try:
        if case["plan"]:
            out[f"{name}/reasons"] = np.array("\n".join(
                repro.plan(case["keys"], case["values"], limits=limits, config=config,
                           **case["kw"]).reasons))
        r = repro.sort(case["keys"], case["values"], limits=limits, config=config, **case["kw"])
        keys = r.keys if isinstance(r.keys, tuple) else (r.keys,)
        for i, k in enumerate(keys):
            out[f"{name}/keys{i}"] = np.asarray(k)
        if r.values is not None:
            out[f"{name}/values"] = np.asarray(r.values)
        if r.counts is not None:
            out[f"{name}/counts"] = np.asarray(r.counts)
    except Exception as e:  # the port must raise the same
        out[f"{name}/error"] = _error(e)
    finally:
        keyenc.PROVENANCE_INT32_CAP = prev


def run_twin(name: str, kind: str, arrays, stable: bool, out: dict) -> None:
    """One of ``repro``'s Pallas kernels, in interpret mode."""
    from repro.kernels import bitonic

    fn = {"sort": bitonic.bitonic_sort_rows, "sort_kv": bitonic.bitonic_sort_rows_kv,
          "merge": bitonic.bitonic_merge_rows, "merge_kv": bitonic.bitonic_merge_rows_kv}[kind]
    kw = dict(stable=stable) if kind.endswith("kv") else {}
    got = fn(*arrays, interpret=True, **kw)
    for i, a in enumerate(got if isinstance(got, tuple) else (got,)):
        out[f"twin {name}/out{i}"] = np.asarray(a)


def main() -> int:
    assert repro.x64_enabled(), "run with REPRO_X64=1"
    out: dict = {}
    for name, case in torch_x64_cases.cases().items():
        run_case(name, case, out)
    for name, (kind, arrays, stable) in torch_x64_cases.twin_cases().items():
        run_twin(name, kind, arrays, stable, out)
    keyenc.PROVENANCE_INT32_CAP = 16
    out["provenance/encode_4_5"] = np.asarray(core_api.encode_provenance(4, 5))
    out["provenance/encode_4_4"] = np.asarray(core_api.encode_provenance(4, 4))
    for x64 in (False, True):
        for n in (16, 17):
            try:
                out[f"provenance/dtype_{n}_{x64}"] = np.array(
                    np.dtype(keyenc.provenance_dtype(n, x64=x64)).name)
            except TypeError as e:
                out[f"provenance/dtype_{n}_{x64}"] = _error(e)
    np.savez(sys.argv[1], **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
