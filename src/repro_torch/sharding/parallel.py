"""The collectives of sharded training, each with its backward.

``repro`` shards its model by GSPMD: it annotates activations and
parameters with partition specs and XLA inserts the collectives, forward
and backward. The port runs one process per rank and writes them out, in
Megatron's manner, as ``torch.autograd.Function``s over the ``AxisGroup``
of a mesh axis (``spec.axis_group``):

  * ``copy_to`` (identity forward, sum backward) where a tensor that every
    rank of "model" holds whole enters a tensor-parallel region: each rank
    takes the gradient of its own heads or columns, and their sum is the
    gradient of the whole. A replicated weight used inside such a region
    (kv projections replicated over "model", the q/k norms, the router
    over tokens split over "model") goes through it too;
  * ``reduce_from`` (sum forward, identity backward) where a row-parallel
    product or the vocab-parallel embedding leaves the region;
  * ``split_seq`` (this rank's slice of the sequence forward, all-gather
    backward) and ``gather_seq`` (all-gather forward, this rank's slice
    backward) around the token-parallel MoE;
  * ``exchange``: the expert all-to-all, flat or factored (``moe._make_a2a``);
    its permutation is its own inverse, so the backward runs it again;
  * ``aux_mean``: the MoE aux loss averaged over every rank of the mesh
    (``lax.pmean``);
  * ``split_halves``: a column-parallel product of two stacked halves
    (Mamba's ``in_proj``, (d, 2 di) over "model" as one contiguous block
    a rank) re-split so that each rank holds its slice of each half: one
    all-to-all over "model", its inverse backward.

What a rank differentiates. Every rank of a "model" group holds the same
loss; the ranks along the batch axes ("pod", "data") hold their block's
share of it, so that the shares sum to the loss of the global batch
(``train/loss.py``). A rank's backward therefore gives, for every
activation it holds, the whole gradient of the global loss, and for every
parameter the part that flows through its own block. The train step sums
the parameters' gradients over the batch axes that do not shard them
(``train/step.py``); a leaf sharded over "data" (experts over ("data",
"model")) gets its other blocks' parts through the exchange's backward.

The aux loss is one term of the loss, computed once for the whole mesh,
so its share on a rank is 1 / batch blocks of it, and ``aux_mean``'s
backward scales the cotangent by batch blocks / mesh ranks: summed over
the ranks, each rank's aux gets 1 / mesh ranks of the loss's gradient,
as the mean's derivative says.

Every rank issues the same collectives in the same order, the backward's
and a rematerialized block's recomputation included: the graphs are the
same on every rank and autograd orders its nodes by creation. Groups over
a tuple of axes are made by a collective call, so ``make_groups`` makes
every group a model needs up front, on every rank.

With no mesh, or a group of one rank, each function is the identity.

Serving runs under ``torch.no_grad()`` and adds three, built on
``gather`` and ``AxisGroup``: ``gather_logits`` (the vocab-parallel head's blocks
over "model": ``repro``'s ``serve_step`` returns whole logits),
``all_max`` with ``reduce_from`` (the log-sum-exp combine of a decode over
a cache whose sequence is split over "model") and ``gather_batch`` (the
rows of every rank along the batch axes, so that every rank's
``generate`` returns the same tokens). ``relay_leaf`` moves a leaf from
one spec to another, as a served MoE model's experts move between the
train layout of prefill and the decode layout (``rules.param_specs``).
"""
from __future__ import annotations

import torch

from repro_torch.sharding.spec import Axes, axis_group


def group(axes: Axes | None, names):
    """This rank's ``AxisGroup`` over ``names`` of ``axes``' mesh, or None
    where nothing is split (no mesh, or one rank)."""
    if axes is None or axes.mesh is None:
        return None
    names = tuple(names) if isinstance(names, (tuple, list)) else (names,)
    if not names:
        return None
    g = axis_group(axes.mesh, names)
    return g if g.size > 1 else None


def make_groups(axes: Axes | None) -> None:
    """Make every group a sharded model and its step use: one collective
    call each for the tuples, in the same order on every rank."""
    if axes is None or axes.mesh is None:
        return
    names = tuple(axes.mesh.mesh_dim_names)
    for g in (*((a,) for a in names), axes.batch, axes.expert, names):
        if g:
            axis_group(axes.mesh, g)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.g.all_sum(grad), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return g.all_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _slice(x, dim: int, g):
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.index * n, n).clone()


def _cat(x, dim: int, g):
    return torch.cat(g.all_gather(x.contiguous()).unbind(0), dim=dim)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _slice(x, dim, g)

    @staticmethod
    def backward(ctx, grad):
        return _cat(grad, ctx.dim, ctx.g), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _cat(x, dim, g)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.g), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad.contiguous()), None


class _AuxMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, aux, g, scale):
        ctx.scale = scale
        return g.all_mean(aux)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None, None


def _halves_moves(g, forward: bool):
    """The chunks of width n that cross in ``split_halves``: the product's
    2 M chunks, chunk k held by coordinate k // 2 (its block of 2 n
    columns) and wanted by coordinate k % M (slot k // M: x, then z).
    Returns (the chunks this rank sends: (chunk, dest, local slot)), (the
    chunks it gets: (chunk, src, slot)), each in (peer, chunk) order, the
    order both sides agree on; backward, the same moves the other way."""
    M, r = g.size, g.index
    held = [(k, k % M, k - 2 * r) for k in (2 * r, 2 * r + 1)]  # at the block's slots
    wanted = [(k, k // 2, k // M) for k in (r, M + r)]  # at the halves' slots
    send, recv = (held, wanted) if forward else (wanted, held)

    def order(move):
        return move[1], move[0]

    return sorted(send, key=order), sorted(recv, key=order)


def _move_halves(t, g, forward: bool):
    """``t`` (..., 2 n): the two chunks of width n this rank holds, to the
    ranks that want them (``_halves_moves``); returns the two it gets in
    slot order."""
    n = t.shape[-1] // 2
    send, recv = _halves_moves(g, forward)
    rows = torch.cat([t[..., s * n:(s + 1) * n].movedim(-1, 0) for _, _, s in send])
    counts = [0] * g.size
    for _, dest, _ in send:
        counts[dest] += n
    got_counts = [0] * g.size
    for _, src, _ in recv:
        got_counts[src] += n
    got = g.all_to_all_v(rows.contiguous(), counts, got_counts).split(n)
    slots = sorted(zip((s for _, _, s in recv), got))
    return torch.cat([piece.movedim(0, -1) for _, piece in slots], dim=-1)


class _SplitHalves(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _move_halves(x, g, True)

    @staticmethod
    def backward(ctx, grad):
        return _move_halves(grad, ctx.g, False), None


def copy_to(x, axes: Axes | None, names=None):
    """Identity forward; the sum over ``names`` (default: "model") backward."""
    g = group(axes, axes.model if names is None and axes is not None else names)
    return x if g is None else _CopyTo.apply(x, g)


def reduce_from(x, axes: Axes | None):
    """The sum over "model" forward; identity backward."""
    g = group(axes, axes.model if axes is not None else ())
    return x if g is None else _ReduceFrom.apply(x, g)


def split(x, dim: int, axes: Axes | None, names):
    """This rank's block of ``dim`` along ``names`` (its coordinate's, the
    first name major) forward; the all-gather of the blocks backward."""
    g = group(axes, names)
    return x if g is None else _Split.apply(x, dim, g)


def gather(x, dim: int, axes: Axes | None, names):
    """The blocks of every rank along ``names``, concatenated in coordinate
    order on ``dim``, forward; this rank's block backward."""
    g = group(axes, names)
    return x if g is None else _Gather.apply(x, dim, g)


def split_seq(x, axes: Axes | None):
    """This rank's slice of the sequence (dim 1) over "model"."""
    return split(x, 1, axes, axes.model if axes is not None else ())


def gather_seq(x, axes: Axes | None):
    """The whole sequence (dim 1) from every rank of "model"."""
    return gather(x, 1, axes, axes.model if axes is not None else ())


def exchange(x, fn):
    """``fn(x)``, an all-to-all whose permutation is its own inverse; its
    backward is ``fn`` of the gradient."""
    return _Exchange.apply(x, fn)


def split_halves(x, axes: Axes | None):
    """``x`` (..., 2 n), this rank's contiguous block of a product over
    "model" whose columns are two halves [a | b] of M n each, as
    [this rank's n of a | its n of b]: the block ``repro``'s spec (None,
    "model") gives each rank of the weight, re-split by one all-to-all
    (``_halves_moves``); backward, the inverse."""
    g = group(axes, axes.model if axes is not None else ())
    return x if g is None else _SplitHalves.apply(x, g)


def aux_mean(aux, axes: Axes):
    """The mean of ``aux`` over every rank of the mesh; backward, the
    cotangent times batch blocks / mesh ranks (module docstring)."""
    g = group(axes, tuple(axes.mesh.mesh_dim_names))
    if g is None:
        return aux
    return _AuxMean.apply(aux, g, axes.batch_size / g.size)


# ------------------------------------------------------ serving (no grad)


def all_max(x, axes: Axes | None):
    """The element-wise maximum of a float tensor over "model"."""
    g = group(axes, axes.model if axes is not None else ())
    return x if g is None else g.all_amax(x)


def gather_logits(logits, axes: Axes | None):
    """Whole-vocabulary logits from the vocab-parallel head's blocks (the
    last dimension over "model")."""
    return gather(logits, -1, axes, axes.model if axes is not None else ())


def batch_axes(B: int, axes: Axes | None):
    """The batch axes that split a global batch of B rows
    (``rules.fit_batch_axes``), or None where nothing splits it."""
    if axes is None or axes.mesh is None:
        return None
    from repro_torch.sharding.rules import fit_batch_axes

    return fit_batch_axes(B, axes)


def batch_rows(x, axes: Axes | None):
    """This rank's rows (dim 0) of a global batch, by ``batch_axes``."""
    names = batch_axes(x.shape[0], axes)
    return x if names is None else shard_leaf(x, (names,), axes)


def gather_batch(x, axes: Axes | None, B: int):
    """Every rank's rows (dim 0) of a global batch of B rows, in order:
    ``batch_rows``' inverse."""
    names = batch_axes(B, axes)
    return x if names is None else gather(x.contiguous(), 0, axes, names)


# ------------------------------------------------- leaves and their specs


def _entry_axes(entry) -> tuple:
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard_leaf(t, spec, axes: Axes | None):
    """This rank's block of ``t`` (a tensor or a numpy array) by ``spec``,
    a view: along each dimension with axes, the block at the rank's
    coordinate. With no mesh ``t`` is whole."""
    if axes is None or axes.mesh is None:
        return t
    from repro_torch.sharding.spec import axis_index, axis_size

    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = _entry_axes(entry)
        n = axis_size(axes.mesh, names)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split "
                             f"over {names} ({n} ranks)")
        size = t.shape[dim] // n
        first = axis_index(axes.mesh, names) * size
        t = t[(slice(None),) * dim + (slice(first, first + size),)]
    return t


def gather_leaf(t, spec, axes: Axes | None):
    """The whole leaf from every rank's block (``shard_leaf``'s inverse): a
    collective over each axis of ``spec``, dimension by dimension."""
    if axes is None or axes.mesh is None:
        return t
    for dim, entry in enumerate(spec):
        if entry is not None:
            g = axis_group(axes.mesh, _entry_axes(entry))
            t = torch.cat(g.all_gather(t.contiguous()).unbind(0), dim=dim)
    return t


def local_shape(shape, spec, axes: Axes | None) -> tuple:
    """The shape of a rank's block of a leaf of ``shape``."""
    if axes is None or axes.mesh_shape is None:
        return tuple(shape)
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            n = 1
            for a in _entry_axes(entry):
                n *= axes.mesh_shape[a]
            out[dim] //= n
    return tuple(out)


def _entry(spec, dim: int) -> tuple:
    e = spec[dim] if dim < len(spec) else None
    return () if e is None else _entry_axes(e)


def _respec_dim(t, dim: int, frm: tuple, to: tuple, axes: Axes):
    """``t``'s dimension ``dim`` from a split over the axes ``frm`` to one
    over ``to`` (either may be (): whole): a slice where it only splits
    more, a gather where it only splits less."""
    if frm == to:
        return t
    if frm:
        t = gather_leaf(t, (None,) * dim + (frm,), axes)
    return shard_leaf(t, (None,) * dim + (to,), axes) if to else t


def relay_leaf(t, src: tuple, dst: tuple, axes: Axes | None):
    """This rank's block of a leaf by spec ``dst``, from its block by
    ``src`` (collective: every rank of the mesh calls it).

    Where "model" moves from one dimension a (last of its axes there) to
    another b, as a served MoE layer's experts move between ``param_specs``'
    train layout (experts over ("model",) or ("data", "model")) and its
    decode layout (d_expert over "model"), it is one all-to-all over
    "model": each rank sends coordinate j its j-th piece along b and
    concatenates what it gets along a. The other axes of a and b are
    gathered or sliced around it (``_respec_dim``). A rank then holds at
    most its block and a few copies of one piece of it, never the whole
    leaf. Any other change gathers the leaf whole and takes the block."""
    if tuple(src) == tuple(dst) or axes is None or axes.mesh is None:
        return t
    m = axes.model
    dims = range(t.dim())
    a = next((d for d in dims if m in _entry(src, d)), None)
    b = next((d for d in dims if m in _entry(dst, d)), None)
    g = group(axes, m)
    simple = (a is not None and b is not None and a != b and g is not None
              and _entry(src, a)[-1] == m and _entry(dst, b)[-1] == m
              and all(_entry(src, d) == _entry(dst, d) for d in dims if d not in (a, b)))
    if not simple:
        return shard_leaf(gather_leaf(t, src, axes), dst, axes).contiguous()
    t = _respec_dim(t, b, _entry(src, b), _entry(dst, b)[:-1], axes)
    pieces = g.all_to_all(torch.stack(t.chunk(g.size, dim=b)))
    t = torch.cat(pieces.unbind(0), dim=a)
    return _respec_dim(t, a, _entry(src, a)[:-1], _entry(dst, a), axes).contiguous()
