"""Mesh axes of the port: ``repro/sharding/spec.py`` on ``torch.distributed``.

``repro``'s mesh is single-controller: ``shard_map`` runs one body per
device of a ``jax.sharding.Mesh``, and its collectives name mesh axes.
The port is SPMD, one process per rank, and its mesh is a
``torch.distributed.device_mesh.DeviceMesh``. ``axis_group(mesh, axis)``
is the counterpart of naming an axis inside ``shard_map``: this rank's
``AxisGroup``, the ranks that share its coordinates on every other mesh
axis, in the order of the mesh's coordinate along ``axis``. A tuple of
axis names is their flattened product, the first name major, as
``P(("data", "model"))`` flattens them. ``axis_size`` is
``axis_size_compat``; ``AxisGroup.index`` is ``lax.axis_index``.

The collectives of the sort (``core/sample_sort.py``) and of the
gradient compression (``optim/compress.py``) are methods of
``AxisGroup``. They move any dtype (as bytes) and put their rows in
coordinate order, whatever the process group's own rank order. A backend
that cannot take a tensor where it lives gets a copy: gloo takes CPU
tensors, so a CUDA tensor on a gloo group goes through the host and back
(``host_staged``; the planner says so in ``SortPlan.reasons``), and NCCL
takes CUDA tensors, so a CPU tensor on an NCCL group goes through the
rank's current CUDA device. The choice is made from the group's backend
name.

``Axes`` (with its head helpers ``pad_heads`` and ``kv_spec``) and
``vocab_pad`` are ``repro``'s, with ``from_mesh`` reading a ``DeviceMesh``.
An ``Axes`` with ``mesh_shape`` and no ``mesh`` describes a mesh without
joining one: the rules (``rules.py``) and the abstract shapes of a
sharded model (``Model(cfg, axes=..., device="meta")``) need no more.
The MoE dispatch's shard index over the expert axes, data-major as
``repro``'s ``_shard_index`` computes it, is ``axis_group(mesh,
axes.expert).index``, and its aux loss's ``lax.pmean`` over every mesh
axis is ``AxisGroup.all_mean``.
``constrain`` (a sharding annotation inside a jitted program) has no
counterpart in eager PyTorch.

``CountingMesh`` stands in for a ``DeviceMesh`` in the dry run
(``launch/dryrun.py``): it describes the production mesh, joins no process
group, and its groups (``CountingGroup``) move nothing and count the bytes
each collective returns, by ``repro``'s kind names (``COLL_KINDS``).
"""
from __future__ import annotations

import dataclasses
import math

import torch


def _dist():
    import torch.distributed as dist

    return dist


def is_device_mesh(obj) -> bool:
    """Whether ``obj`` is a ``DeviceMesh`` (False where torch has no
    distributed support)."""
    dist = _dist()
    if not dist.is_available():
        return False
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(obj, DeviceMesh)


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _dim(mesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"the mesh has no axis {name!r}; its axes are {names}")
    return names.index(name)


def axis_size(mesh, axis) -> int:
    """The number of ranks along ``axis`` (a name or a tuple of names)."""
    return math.prod(mesh.size(_dim(mesh, a)) for a in _axes(axis))


def axis_index(mesh, axis) -> int:
    """This rank's coordinate along ``axis``; for a tuple of names the
    flattened coordinate, the first name major."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    index = 0
    for a in _axes(axis):
        d = _dim(mesh, a)
        index = index * mesh.size(d) + coord[d]
    return index


class AxisGroup:
    """This rank's process group along one mesh axis or a tuple of axes.

    ranks: the global ranks of the group in coordinate order; index: this
    rank's coordinate (its row in every gathered result); size: p.
    """

    def __init__(self, group, ranks):
        dist = _dist()
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.backend = str(dist.get_backend(group))
        # the process group's rank of coordinate i (new_group sorts ranks)
        self._grank = [dist.get_group_rank(group, r) for r in self.ranks]
        self._coord = [0] * self.size
        for i, g in enumerate(self._grank):
            self._coord[g] = i
        self._identity = self._grank == list(range(self.size))

    def host_staged(self, device: torch.device) -> bool:
        """Whether tensors on ``device`` go through the host: a CUDA
        tensor on a group whose backend has no CUDA transport."""
        return device.type == "cuda" and "nccl" not in self.backend

    def _on_backend(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it (a copy if it is elsewhere)."""
        if self.host_staged(t.device):
            return t.cpu()
        if t.device.type == "cpu" and "gloo" not in self.backend:
            return t.to(torch.device("cuda", torch.cuda.current_device()))
        return t

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it, as contiguous bytes."""
        return self._on_backend(t).contiguous().reshape(-1).view(torch.uint8)

    def _rows(self, rows: torch.Tensor, to_group: bool) -> torch.Tensor:
        """Rows indexed by coordinate put in group-rank order, or back."""
        if self._identity:
            return rows
        perm = self._coord if to_group else self._grank
        return rows[torch.tensor(perm, device=rows.device)]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(p, *t.shape): row i is coordinate i's ``t``, on ``t``'s device
        (``lax.all_gather``; tiled by a reshape)."""
        dist = _dist()
        wire = self._wire(t)
        out = torch.empty((self.size, wire.numel()), dtype=torch.uint8, device=wire.device)
        dist.all_gather(list(out.unbind(0)), wire, group=self.group)
        out = self._rows(out, to_group=False)
        return out.view(t.dtype).reshape(self.size, *t.shape).to(t.device)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (p, ...): row j goes to coordinate j; row i of the result
        came from coordinate i (``lax.all_to_all(split_axis=0,
        concat_axis=0, tiled=True)``)."""
        dist = _dist()
        send = self._wire(self._rows(t, to_group=True)).reshape(self.size, -1)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        recv = self._rows(recv, to_group=False)
        return recv.view(t.dtype).reshape(t.shape).to(t.device)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (p * n, ...) summed over the group, block i to coordinate
        i (``lax.psum_scatter(scatter_dimension=0, tiled=True)``): an
        all-to-all of the blocks, then their sum in coordinate order."""
        blocks = self.all_to_all(t.reshape(self.size, -1, *t.shape[1:]))
        return blocks.sum(0)

    def swap(self, t: torch.Tensor, partner: int, n_recv: int) -> torch.Tensor:
        """Send all of ``t`` (flat) to coordinate ``partner`` and return the
        ``n_recv`` elements it sends back; every rank of the group takes
        part, as one all-to-all with per-destination sizes."""
        dist = _dist()
        wire = self._wire(t)
        item = t.element_size()
        send_sizes, recv_sizes = [0] * self.size, [0] * self.size
        send_sizes[self._grank[partner]] = wire.numel()
        recv_sizes[self._grank[partner]] = n_recv * item
        recv = torch.empty(n_recv * item, dtype=torch.uint8, device=wire.device)
        dist.all_to_all_single(recv, wire, recv_sizes, send_sizes, group=self.group)
        return recv.view(t.dtype).to(t.device)

    def all_to_all_v(self, t: torch.Tensor, send_sizes, recv_sizes) -> torch.Tensor:
        """Rows of ``t`` by destination: its first ``send_sizes[0]`` rows go
        to coordinate 0, the next ``send_sizes[1]`` to coordinate 1, and so
        on; returns the ``sum(recv_sizes)`` rows received, coordinate 0's
        first (``recv_sizes[i]``: how many coordinate i sends here)."""
        dist = _dist()
        row = math.prod(t.shape[1:]) * t.element_size()
        order = self._coord  # coordinate of each group rank
        send = [int(send_sizes[c]) * row for c in order]
        recv = [int(recv_sizes[c]) * row for c in order]
        wire = self._wire(t)
        if not self._identity:
            pieces = wire.split([int(s) * row for s in send_sizes])
            wire = torch.cat([pieces[c] for c in order])
        out = torch.empty(sum(recv), dtype=torch.uint8, device=wire.device)
        dist.all_to_all_single(out, wire, recv, send, group=self.group)
        if not self._identity:
            pieces = out.split(recv)
            out = torch.cat([pieces[g] for g in self._grank])
        return out.view(t.dtype).reshape(-1, *t.shape[1:]).to(t.device)

    def all_max(self, values) -> list:
        """The element-wise maximum over the group of a few host integers
        (``lax.pmax``), as a list."""
        dist = _dist()
        wire = self._on_backend(torch.tensor([int(v) for v in values], dtype=torch.int64))
        dist.all_reduce(wire, op=dist.ReduceOp.MAX, group=self.group)
        return wire.tolist()

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The element-wise sum over the group of a float tensor of any
        shape (``lax.psum``), on ``t``'s device, ``t`` left as it was.
        Types narrower than float32 are summed in float32, then cast back;
        every rank gets the same bits."""
        dist = _dist()
        wide = t.dtype in (torch.float32, torch.float64)
        wire = self._on_backend(t if wide else t.float())
        wire = wire.clone(memory_format=torch.contiguous_format) if wire is t else wire.contiguous()
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.group)
        return wire.to(device=t.device, dtype=t.dtype)

    def all_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``all_sum`` written back into ``t`` (contiguous float32 or
        float64), with no second tensor of its size on its device: in
        place where the backend takes ``t`` where it lives, else through
        the host copy. Returns ``t``."""
        dist = _dist()
        wire = self._on_backend(t)
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.group)
        if wire is not t:
            t.copy_(wire)
        return t

    def all_amax(self, t: torch.Tensor) -> torch.Tensor:
        """The element-wise maximum over the group of a float tensor of any
        shape (``lax.pmax``), on ``t``'s device, ``t`` left as it was."""
        dist = _dist()
        wire = self._on_backend(t)
        wire = wire.clone(memory_format=torch.contiguous_format) if wire is t else wire.contiguous()
        dist.all_reduce(wire, op=dist.ReduceOp.MAX, group=self.group)
        return wire.to(t.device)

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the group of a float tensor (``lax.pmean``: the
        sum, then divided by p), on ``t``'s device."""
        dist = _dist()
        wire = self._on_backend(t).reshape(1).clone()
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.group)
        return (wire / self.size).reshape(t.shape).to(t.device)


# Each collective of ``AxisGroup`` by the kind ``repro``'s HLO names it
# (``hlo_stats._COLL``); the sort's swap is ``repro``'s ``ppermute``.
COLL_KINDS = {"all_sum": "all-reduce", "all_sum_": "all-reduce", "all_mean": "all-reduce",
              "all_amax": "all-reduce", "all_max": "all-reduce", "all_gather": "all-gather",
              "all_to_all": "all-to-all", "all_to_all_v": "all-to-all",
              "reduce_scatter": "reduce-scatter", "swap": "collective-permute"}


def out_bytes(out) -> int:
    """The bytes a collective returns: a tensor's, or 8 for each of
    ``all_max``'s host integers (int64 on the wire)."""
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    return 8 * len(out)


class CountingMesh:
    """A stand-in for a ``DeviceMesh`` of ``shape`` over ``names`` that
    joins no process group: the dry run's mesh (``launch/dryrun.py``).
    ``get_coordinate`` is rank 0's. ``axis_group`` gives a
    ``CountingGroup`` over it, whose collectives move nothing and add the
    bytes they return to ``colls``, by ``COLL_KINDS``."""

    def __init__(self, shape, names):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(names)} differ in rank")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(self.shape)
        self.colls: dict = {}

    def size(self, dim: int | None = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]

    def get_coordinate(self) -> list:
        return [0] * self.ndim


class CountingGroup:
    """``AxisGroup``'s collectives on a ``CountingMesh``: each returns a
    tensor of the shape and dtype the real one returns, zeros on the
    input's device (``all_sum_`` returns its input, ``all_max`` the
    values), and records that output's bytes on the mesh. Each method
    records once: none calls another, so ``reduce_scatter`` (an
    all-to-all and a sum on a real group) counts as one reduce-scatter."""

    def __init__(self, mesh: CountingMesh, size: int):
        self.mesh, self.size, self.index = mesh, size, 0

    def _out(self, method: str, out):
        kind = COLL_KINDS[method]
        self.mesh.colls[kind] = self.mesh.colls.get(kind, 0) + out_bytes(out)
        return out

    def all_gather(self, t):
        return self._out("all_gather", t.new_zeros((self.size, *t.shape)))

    def all_to_all(self, t):
        return self._out("all_to_all", t.new_zeros(t.shape))

    def reduce_scatter(self, t):
        return self._out("reduce_scatter", t.new_zeros((t.shape[0] // self.size, *t.shape[1:])))

    def swap(self, t, partner: int, n_recv: int):
        return self._out("swap", t.new_zeros(n_recv))

    def all_to_all_v(self, t, send_sizes, recv_sizes):
        return self._out("all_to_all_v", t.new_zeros((int(sum(recv_sizes)), *t.shape[1:])))

    def all_max(self, values) -> list:
        return self._out("all_max", [int(v) for v in values])

    def all_sum(self, t):
        return self._out("all_sum", t.new_zeros(t.shape))

    def all_sum_(self, t):
        return self._out("all_sum_", t)

    def all_amax(self, t):
        return self._out("all_amax", t.new_zeros(t.shape))

    def all_mean(self, t):
        return self._out("all_mean", t.new_zeros(t.shape))


_GROUPS: dict = {}


def axis_group(mesh, axis="data") -> AxisGroup:
    """This rank's ``AxisGroup`` along ``axis`` of ``mesh`` (a name, or a
    tuple of names: their flattened product, the first name major).

    One name is ``mesh.get_group(name)``. A tuple builds the groups from
    ``mesh.mesh`` with ``new_subgroups_by_enumeration``, which every rank
    of the world must call, in the same order: the first sort over a new
    tuple is a collective call. Cached per mesh object and axes (the
    cache keeps the mesh alive, so its id is not reused). On a
    ``CountingMesh``, its ``CountingGroup``."""
    axes = _axes(axis)
    if isinstance(mesh, CountingMesh):
        return CountingGroup(mesh, axis_size(mesh, axes))
    dist = _dist()
    key = (id(mesh), axes)
    if key in _GROUPS:
        return _GROUPS[key][1]
    dims = [_dim(mesh, a) for a in axes]
    rest = [d for d in range(mesh.ndim) if d not in dims]
    table = mesh.mesh.permute(*rest, *dims).reshape(-1, axis_size(mesh, axes))
    me = dist.get_rank()
    mine = next(row for row in table.tolist() if me in row)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        group, _ = dist.new_subgroups_by_enumeration(table.tolist())
    found = AxisGroup(group, mine)
    _GROUPS[key] = (mesh, found)
    return found


def as_axis_group(where) -> AxisGroup:
    """An ``AxisGroup`` from an ``AxisGroup``, a ``(mesh, axis)`` pair or a
    bare mesh (axis "data", ``repro``'s default)."""
    if isinstance(where, AxisGroup):
        return where
    if isinstance(where, (tuple, list)) and len(where) == 2 and is_device_mesh(where[0]):
        return axis_group(*where)
    if is_device_mesh(where):
        return axis_group(where, "data")
    raise TypeError(f"expected a DeviceMesh, (DeviceMesh, axis) or an AxisGroup, "
                    f"got {type(where).__name__}")


@dataclasses.dataclass(frozen=True)
class Axes:
    """``repro``'s axis roles: batch over ("pod", "data"), heads, MLP and
    vocabulary over "model", MoE experts over "model" or ("data", "model");
    ``mesh_shape`` maps axis name to size."""

    batch: tuple[str, ...] = ("data",)
    model: str = "model"
    expert: tuple[str, ...] = ("model",)
    mesh_shape: dict | None = None
    mesh: object = None

    @property
    def model_size(self) -> int:
        return self.mesh_shape[self.model] if self.mesh_shape else 1

    @property
    def expert_size(self) -> int:
        if not self.mesh_shape:
            return 1
        return math.prod(self.mesh_shape[a] for a in self.expert)

    @property
    def batch_size(self) -> int:
        """The number of batch blocks: the product of the batch axes."""
        if not self.mesh_shape:
            return 1
        return math.prod(self.mesh_shape[a] for a in self.batch)

    def pad_heads(self, h: int) -> int:
        """``h`` rounded up to a multiple of the model axis."""
        m = self.model_size
        return ((h + m - 1) // m) * m

    def kv_spec(self, kv_heads: int):
        """The model axis when it divides the KV heads (and is no larger),
        else None: the KV heads are replicated."""
        m = self.model_size
        return self.model if (kv_heads % m == 0 and kv_heads >= m) else None


def from_mesh(mesh, expert_2d: bool = False) -> Axes | None:
    """``Axes`` of a ``DeviceMesh`` or a ``CountingMesh`` (None for no
    mesh)."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names
    return Axes(
        batch=tuple(a for a in ("pod", "data") if a in names),
        model="model",
        expert=("data", "model") if expert_2d else ("model",),
        mesh_shape={a: mesh.size(i) for i, a in enumerate(names)},
        mesh=mesh,
    )


def vocab_pad(vocab: int, axes: Axes | None = None, multiple: int = 128) -> int:
    """``vocab`` rounded up to a multiple of ``max(multiple, model size)``."""
    step = max(multiple, axes.model_size if axes else 1)
    return ((vocab + step - 1) // step) * step
