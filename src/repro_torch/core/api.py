"""Sort API: ``sort``, ``plan`` and ``explain``.

Counterpart of the unified front end of ``repro/core/api.py``::

    import repro_torch
    out = repro_torch.sort(keys)             # -> SortOutput, on "cuda"
    out.keys                                 # sorted keys, a device tensor
    repro_torch.sort(keys, device="cpu")     # the plain path, on the CPU
    out = repro_torch.sort((ids, times), order=("asc", "desc"))
    out.keys                                 # (ids, times), sorted by ids, then times

keys:   a flat tensor or numpy array, a (p, n_local) grid whose rows
        are the shards, a tuple of equal-length columns (a lexicographic
        multi-key sort; a 1-tuple is a single key), or an iterator (a
        list) of arrays, which streams.
values: optional payload that rides the sort.
order:  "asc" | "desc", or a tuple with one flag per key.
want:   "values" (sorted keys [+ payload]) | "order" (the stable sorting
        permutation).
where:  backend override: "sim" or "stream" (the mesh is not ported).
limits: ``SortLimits``; config: ``SortConfig`` (the paper's defaults).
device: None means "cuda", which must exist; "cpu" on request only.

Stream (``where="stream"``, iterators, and inputs above
``SortLimits.stream_threshold`` = 2^22 elements): the keys stay where they
are and move to the device chunk by chunk (``chunk_elems``); the output
comes back as CPU tensors, lazily: ``.keys`` / ``.values`` / ``.order()``
run the passes, or ``out.chunks()`` yields the sorted chunks in bounded
memory (keys-only results; column tuples for a packed multi-key sort).
``SortLimits(trace=True)`` puts the phase spans on ``out.meta.trace``.

Multi-key strategy (``plan.multikey``, ``SortLimits.multikey``): when the
columns' measured (or declared, ``SortLimits.key_bits``) bit widths fit
31 bits, the tuple packs into ONE non-negative int32 key and sorts in one
pass ("packed"); otherwise, or for unpackable columns (float16,
bfloat16, a float column holding NaN), one stable argsort pass per key
("lsd"). ``repro_torch.explain`` names the decision and its reason. A
packed sort with a payload cannot hold a tuple that saturates a full
31-bit pack (it is the int32 padding sentinel) and raises ``repro``'s
ValueError; packed keys-only sorts have no restriction.

Decode (``SortLimits.decode``): "device" (default) builds the output on
the sort's device; "host" copies the result grid to the CPU and decodes
it with numpy, as ``repro``'s legacy path does. Both give the same bits;
the host decode returns CPU tensors.

x64 mode (``core.x64``): int64, uint64 and float64 keys and values are
refused at the door with ``repro``'s TypeError unless the mode is on
(``enable_x64()``, ``REPRO_X64=1``, ``x64_mode()`` for a block, or
``SortLimits(x64=True)`` for one request; ``SortLimits(x64=False)`` keeps
a request at 32 bits). In the mode they sort through the 64-bit
instantiations of the bitonic kernels; tuples pack into one int64 sort up
to 63 bits; an argsort of more than 2^31 elements returns int64 indices.

Views (``SortOutput.topk``, ``.searchsorted``, ``.provenance``) and
``encode_provenance`` / ``decode_provenance`` / ``load_imbalance`` are
``repro``'s, on tensors.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.core import keyenc, planner
from repro_torch.core import x64 as _x64
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


# ---------------------------------------------------------- provenance


def encode_provenance(p: int, n_local: int, device=None) -> torch.Tensor:
    """(p, n_local) index payload: global position = proc * n_local + local
    index, unique and increasing, so a kv sort carrying it is exactly
    stable and each element's (processor, location) can be recovered. int32
    up to ``keyenc.PROVENANCE_INT32_CAP`` elements; past that int64, which
    needs x64 mode (``keyenc.provenance_dtype`` raises otherwise)."""
    dt = keyenc.provenance_dtype(p * n_local, x64=_x64.x64_enabled())
    return torch.arange(p * n_local, dtype=dt, device=_device.resolve(device)).reshape(p, n_local)


def decode_provenance(payload: torch.Tensor, n_local: int):
    """(processor, local index) of each provenance value."""
    return payload // n_local, payload % n_local


def load_imbalance(counts) -> torch.Tensor:
    """max/mean shard size; 1.0 is perfect balance (paper Table II). A
    float32 scalar (float64 for 64-bit counts), as ``repro``'s."""
    c = planner.as_tensor(counts)
    wide = torch.float64 if c.dtype.itemsize == 8 else torch.float32
    return c.max().to(wide) / torch.clamp(c.to(wide).mean(), min=1)
