"""The vocabulary padding of ``repro/sharding/spec.py``.

Only the single-device case (``axes=None``) is ported: without a mesh
``constrain`` is the identity, so the port does not carry it. The mesh is
ROADMAP.md §1 item 9.
"""
from __future__ import annotations


def vocab_pad(vocab: int, axes=None, multiple: int = 128) -> int:
    """``vocab`` rounded up to a multiple of ``multiple``."""
    if axes is not None:
        raise NotImplementedError(
            "sharded vocab padding needs the mesh, not ported to repro_torch yet "
            "(ROADMAP.md §1, item 9 (mesh backend))")
    return ((vocab + multiple - 1) // multiple) * multiple
