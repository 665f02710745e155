"""Roofline statistics of one rank's eager program: the port's
``repro/launch/hlo_stats.py``.

``repro`` parses the optimized HLO of a compiled program and walks its
call graph, multiplying loop bodies by their trip counts. The port has no
HLO and reads none: ``Counts`` is a context manager that counts the aten
ops (and the ``repro_torch`` kernel ops) an eager program dispatches
inside it, each as often as it runs, on any device. On the meta device
(the dry run, ``launch/dryrun.py``) nothing is allocated or computed, and
the kernels' fakes give their outputs' shapes. ``Counts.result()`` is
``aggregate``'s dict, ``dot_flops``, ``traffic``, ``colls`` and
``coll_bytes``, with ``kernels`` (calls of each ``repro_torch`` op) and
``peak_bytes`` added.

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s formulas
    (its ``flop_registry``), the matrix products (mm, addmm, bmm,
    baddbmm, convolutions) at 2 M N K each, and the flash kernel by its
    formula (``kernels/flash.flash_flops``: 2 B H (dqk + dv) a kept
    (query, key) pair), applied in the one mode that counts the rest (a
    composite op that reaches it is counted through its parts, as
    ``FlopCounterMode`` counts it); the tests hold the two equal.
    Elementwise FLOPs are ignored, as ``repro``'s are.
  * Collective bytes: the bytes each collective returns, by ``repro``'s
    kind names, recorded by the ``CountingGroup``s of the ``CountingMesh``
    given to ``Counts`` (``sharding/spec.py``); a real group moves and
    records nothing here.
  * HBM traffic, ``repro``'s fusion-ideal model mapped to aten ops:
      - every operand and the output of each matrix product and of the
        flash op (``repro``: dot operands and output);
      - twice the output of gathers and index ops (``index``,
        ``index_select``, ``gather``, ``embedding``), of scatters
        (``scatter*``, ``index_put``, ``index_add``, ``index_copy``), of
        cache writes and other copies into a tensor (``copy_``,
        ``slice_scatter``: ``repro``'s dynamic-update-slice), of sorts
        (``sort``, ``topk``, the four bitonic ops), of ``cumsum``
        (``repro``'s reduce-window) and of reductions (``sum``, ``mean``,
        ``amax``, ``amin``, ``max`` / ``min`` over a dimension, ``prod``,
        ``logsumexp``, norms): written once and read back once.
    Departures: (1) ``repro`` scans over stacked layer weights and
    charges each layer's ``dynamic-slice`` of them, a copy the port never
    makes: its matrix products read each weight where it lies, counted
    once as their operand; so nothing stands for it. (2) ``repro``'s CPU
    backend runs a bfloat16 dot in float32 and counts its operands so; the
    port counts the dtype the card reads, so on a bfloat16 model its
    product bytes are half of ``repro``'s CPU figure. (3) ``repro`` charges
    no reduce fused into a neighbour; the port sees no fusion and charges
    every reduction (outputs a row each, small beside the products). A
    softmax's reductions are inside ``_softmax`` and not charged.
  * Peak live bytes: every storage an op makes inside ``Counts`` adds its
    bytes when it is made and subtracts them when it is freed (a weakref
    finalizer on the storage); ``temp_peak`` is the running maximum.
    Storages made before (parameters, optimizer states, caches, the batch)
    are the caller's ``args``; ``peak_bytes`` is ``args + temp_peak``.
    Allocations inside a kernel op (its scratch) are not seen.
"""
from __future__ import annotations

import threading
import weakref

import torch
from torch._C import DispatchKey
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import flash  # noqa: F401  (registers flash's FLOP formula)

_aten = torch.ops.aten
# twice the output: written once, read back once (module docstring)
_TWICE_OUT = {
    _aten.index, _aten.index_select, _aten.gather, _aten.embedding, _aten.take,
    _aten.scatter, _aten.scatter_, _aten.scatter_add, _aten.scatter_add_,
    _aten.scatter_reduce, _aten.scatter_reduce_, _aten.index_put, _aten.index_put_,
    _aten._index_put_impl_, _aten.index_add, _aten.index_add_, _aten.index_copy,
    _aten.index_copy_, _aten.copy_, _aten.slice_scatter, _aten.select_scatter,
    _aten.sort, _aten.topk, _aten.cumsum, _aten.cumsum_,
    _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min, _aten.prod,
    _aten.logsumexp, _aten.linalg_vector_norm, _aten.norm,
}
_KERNEL_NS = "repro_torch"
_SORTS = {"sort_rows", "sort_rows_kv", "merge_rows", "merge_rows_kv"}


def _flat(items) -> list:
    """The tensors among ``items`` and in their lists and tuples."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(x) for x in tree)
    return 0


def _kind(func):
    """How ``Counts`` counts ``func`` (module docstring): "kernel" (a
    ``repro_torch`` op), "product", "twice", "decompose" (a composite
    op that reaches the mode, counted through its parts, as
    ``FlopCounterMode`` does) or None."""
    packet = func._overloadpacket
    if func.namespace == _KERNEL_NS:
        return "kernel"
    if packet in flop_registry:
        return "product"
    if (DispatchKey.CompositeImplicitAutograd in func.py_kernels
            or torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), DispatchKey.CompositeImplicitAutograd)):
        return "decompose"
    return "twice" if packet in _TWICE_OUT else None


class _Mode(TorchDispatchMode):
    def __init__(self, counts: "Counts"):
        super().__init__()
        self.c = counts
        self.kinds: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self.kinds.get(func, 0)
        if kind == 0:
            kind = self.kinds[func] = _kind(func)
        if kind == "decompose":
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        c = self.c
        ins = _flat(args) + _flat(kwargs.values())
        outs = _flat(out if isinstance(out, (list, tuple)) else (out,))
        if kind == "kernel":
            name = func.name().split("::")[1].split(".")[0]
            c.kernels[name] = c.kernels.get(name, 0) + 1
        if kind == "product" or (kind == "kernel" and func._overloadpacket in flop_registry):
            c.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
            c.traffic += _nbytes(ins) + _nbytes(outs)
        elif kind == "twice" or (kind == "kernel" and name in _SORTS):
            c.traffic += 2 * _nbytes(outs)
        c._track(ins, outs)
        return out


class Counts:
    """Counts one rank's program: enter it around the program, then read
    ``result()`` (module docstring). ``mesh``: the ``CountingMesh`` whose
    collectives to report (its ``colls`` are cleared on entry); ``args``:
    the bytes of the program's inputs made before it (parameters,
    optimizer states, caches, batch)."""

    def __init__(self, mesh=None, args: int = 0):
        self.mesh = mesh
        self.args = int(args)
        self.kernels: dict = {}
        self.flops = 0
        self.traffic = 0
        self.live = 0
        self.temp_peak = 0
        self._storages: set = set()
        self._lock = threading.Lock()
        self._mode = _Mode(self)

    def __enter__(self):
        if self.mesh is not None:
            self.mesh.colls.clear()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False

    def _track(self, ins, outs) -> None:
        """Add each storage an op made (none of its inputs'), and a
        finalizer that takes it off when it is freed."""
        seen = None
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            if seen is None:
                seen = {i.untyped_storage()._cdata for i in ins}
            n = st.nbytes()
            if key in seen or n == 0:
                continue
            seen.add(key)
            with self._lock:
                self._storages.add(key)
                self.live += n
                self.temp_peak = max(self.temp_peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        with self._lock:
            self._storages.discard(key)
            self.live -= n

    def result(self) -> dict:
        colls = dict(self.mesh.colls) if self.mesh is not None else {}
        return {"dot_flops": float(self.flops),
                "traffic": float(self.traffic),
                "colls": colls,
                "coll_bytes": float(sum(colls.values())),
                "kernels": dict(sorted(self.kernels.items())),
                "args_bytes": self.args,
                "temp_peak_bytes": self.temp_peak,
                "peak_bytes": self.args + self.temp_peak}
