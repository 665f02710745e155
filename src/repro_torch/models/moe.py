"""Mixture-of-Experts with sort-based dispatch: ``repro/models/moe.py``.

Token routing is a distributed sort keyed by expert id: E distinct keys,
the investigator's duplicate-heavy case (paper Table II). Per MoE layer
the dispatch runs the paper's six steps:

  (1) a stable local argsort of the (expert id, slot) pairs
      (``core.keyenc.stable_argsort``; with ``use_pallas=True`` on the
      card the ``sort_rows_kv`` and ``merge_rows_kv`` kernels);
  (2-4) static splitters, the first expert of each shard; the capacity
      clip bounds every destination's load;
  (5) one static-capacity all_to_all of keys and token vectors over the
      expert axes;
  (6) the received buckets grouped by expert with the balanced pairwise
      merge (``core.merge.merge_padded_runs_kv``).

Expert parallelism is SPMD, one process per rank, where ``repro`` runs
one ``shard_map`` program. Every rank of the mesh calls ``moe_forward``
with

  * its block of the global (B, S, d) tokens, ``local_tokens(x, axes)``:
    the batch split over ``rules.fit_batch_axes(B, axes)`` and, when S
    divides by the size of the "model" axis, the sequence split over
    "model"; along an axis that splits nothing the ranks hold the same
    tokens (decode, S == 1, is replicated over "model"). This is
    ``repro``'s ``P(bax, sax, None)``. With one expert shard nothing is
    split: every rank passes all of x;
  * its slice of the experts, ``shard_params(moe, axes)``: experts
    [shard * E_loc, (shard + 1) * E_loc), where shard is the rank's
    coordinate on the expert axes, data-major (``P(axes.expert, None,
    None)``), and the whole router;

and gets the output of its block and the aux loss averaged over every
rank of the mesh. The exchange runs over ``axis_group(mesh,
axes.expert)``: ("model",), or ("data", "model") for 2-D expert
parallelism, which ``cfg.hierarchical_a2a`` factors into an exchange over
"data" and one over "model".

Both are differentiable (``sharding/parallel.py``): the exchange's
backward is the same exchange of the gradients, the aux mean's gives each
rank its part, and ``local_tokens`` takes the blocks with ``split``, whose
backward gathers the gradients of the blocks. A sharded model
(``transformer.apply_block``) already holds its batch block, holds its
experts, splits the sequence over "model" itself (``split_seq``,
``gather_seq`` on the output) and passes the router through ``copy_to``:
each rank of "model" routes its own slice, so the router's gradient is
the sum of theirs.

``jnp``'s out-of-range scatters drop (``mode="drop"``) and its gathers
clamp. Here each scatter writes its dropped rows into one extra row that
is cut off after it, and each gather clamps its index before the mask.
The capacities are ``repro``'s formulas, so the same tokens drop.
The dispatch is differentiable as ``repro``'s: the sort's keys and slots
are integers, and gradients flow through the router's gate weights, the
gathers, the scatters and the combine.
``moe_forward_decode`` gathers each token's top-k expert slices (under a
mesh from every expert's slice of d_expert over "model"), and
``moe_forward(..., tp_axis=)`` is ``repro``'s EP x TP decode (experts
over "data", d_expert over "model"); ``moe_ref`` is the dense one-hot
oracle. Within ``recording_drops()``
each dispatch notes how many assignments its two capacities dropped.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _act, _init, torch_dtype
from repro_torch.sharding import parallel as par
from repro_torch.sharding.rules import fit_batch_axes
from repro_torch.sharding.spec import Axes, axis_group


class MoE(nn.Module):
    """``init_moe``'s leaves: ``router`` (d, E) float32; ``wi``, ``wg``
    (E, d, de) and ``wo`` (E, de, d) in cfg.dtype (on one rank of a mesh:
    its E_loc experts)."""

    def __init__(self, router, wi, wg, wo):
        super().__init__()
        self.router, self.wi, self.wg, self.wo = (
            t if isinstance(t, nn.Parameter) else nn.Parameter(t) for t in (router, wi, wg, wo))


_LOCAL = threading.local()


@contextlib.contextmanager
def recording_drops():
    """Within it, each dispatch on this thread appends (assignments,
    dropped at the send capacity C, dropped at the expert capacity) to the
    list this yields, read from the device (a synchronisation each)."""
    prev, _LOCAL.drops = getattr(_LOCAL, "drops", None), []
    try:
        yield _LOCAL.drops
    finally:
        _LOCAL.drops = prev


def init_moe(cfg, gen, device=None) -> MoE:
    dtype = torch_dtype(cfg.dtype)
    d, de, E = cfg.d_model, cfg.d_expert, cfg.n_experts
    return MoE(_init(gen, (d, E), d ** -0.5, torch.float32, device),
               _init(gen, (E, d, de), d ** -0.5, dtype, device),
               _init(gen, (E, d, de), d ** -0.5, dtype, device),
               _init(gen, (E, de, d), de ** -0.5, dtype, device))


def _router(xf, router_w, cfg):
    """Softmax top-k routing with renormalized weights and the Switch aux
    loss. ``lax.top_k`` breaks ties by the lower index, as a stable
    descending sort does (``torch.topk`` promises no order). The logits
    are float32; PyTorch keeps TF32 off for matmuls unless a caller
    turned it on, which would flip expert ids against the CPU."""
    logits = xf.float() @ router_w  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :cfg.moe_topk], ids[:, :cfg.moe_topk]  # (T, K)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    # load-balance aux (Switch): E * sum_e f_e * P_e
    E = router_w.shape[-1]
    # the count of each expert id (bincount's, as a scatter of ones: the
    # dry run's meta tensors have a kernel for it; counts below 2^24 are
    # exact in float32)
    flat = ids.reshape(-1)
    f = torch.zeros(E, dtype=torch.float32, device=flat.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=flat.device))
    f = f / torch.clamp_min(f.sum(), 1.0)
    aux = E * torch.sum(f * probs.mean(0))
    return w, ids.to(torch.int32), aux


def _expert_ffn(xe, moe: MoE, cfg):
    """xe: (E_loc, cap, d) -> (E_loc, cap, d). Batched per-expert SwiGLU."""
    return (_act(xe @ moe.wg, cfg.act) * (xe @ moe.wi)) @ moe.wo


def _dispatch_body(xf, moe: MoE, cfg, *, n_shards: int, shard_id: int, a2a,
                   use_pallas: bool = True, tp_axis=None):
    """One rank's dispatch (the paper's six steps). xf: (T, d). Returns
    (out (T, d), aux, send_counts (n_shards,) int32). ``tp_axis``: the
    ``AxisGroup`` over which ``moe`` holds a slice of d_expert (EP x TP);
    the expert FFN's partial outputs are summed over it, as ``repro``
    psums them."""
    # the sort library loads at the first dispatch: a dense model never needs it
    from repro_torch.core import keyenc
    from repro_torch.core.merge import merge_padded_runs_kv

    T, d = xf.shape
    dev = xf.device
    E, K = cfg.n_experts, cfg.moe_topk
    E_loc = E // n_shards
    A = T * K  # local assignments

    w, ids, aux = _router(xf, moe.router, cfg)

    # ---- (1) local stable argsort of expert ids (slot payload)
    skeys, sslots = keyenc.stable_argsort(ids.reshape(-1), use_pallas=use_pallas)

    # ---- (2-4) static splitters = first expert of each shard
    shard_first = torch.arange(n_shards + 1, dtype=torch.int32, device=dev) * E_loc
    bounds = torch.searchsorted(skeys, shard_first, side="left")
    send_counts = bounds[1:] - bounds[:-1]  # (n_shards,)
    C = max(1, int((A + n_shards - 1) // n_shards * cfg.moe_capacity_factor) + 1)

    # ---- (5) bucketize + all_to_all (keys + token vectors)
    pos = torch.arange(C, device=dev)
    idx = bounds[:-1, None] + pos[None, :]  # (n_shards, C)
    valid = pos[None, :] < send_counts[:, None]
    idx_c = idx.clamp(max=A - 1)
    bkeys = torch.where(valid, skeys[idx_c], E)  # sentinel = E (max)
    bslots = torch.where(valid, sslots[idx_c], A)
    btok = torch.where(valid[..., None], xf[bslots.clamp(max=A - 1).long() // K], 0)
    rkeys = a2a(bkeys)  # (n_shards, C)
    rtok = a2a(btok)  # (n_shards, C, d)

    # ---- (6) group by local expert: balanced pairwise merge (Fig. 2)
    n_pool = n_shards * C
    pool_idx = torch.arange(n_pool, dtype=torch.int32, device=dev).reshape(n_shards, C)
    mkeys, mpool = merge_padded_runs_kv(rkeys, pool_idx, use_pallas=use_pallas)
    pool = rtok.reshape(n_pool, d)

    # per-expert segments + capacity (the investigator's balance bound)
    first = shard_id * E_loc
    e_bounds = torch.searchsorted(
        mkeys, first + torch.arange(E_loc + 1, dtype=torch.int32, device=dev), side="left")
    cap_e = max(1, int(T * K * n_shards // max(E, 1) * cfg.moe_capacity_factor) + 1)
    drops = getattr(_LOCAL, "drops", None)
    if drops is not None:
        drops.append((A, int((send_counts - C).clamp(min=0).sum()),
                      int((e_bounds[1:] - e_bounds[:-1] - cap_e).clamp(min=0).sum())))
    eidx = e_bounds[:-1, None] + torch.arange(cap_e, device=dev)[None, :]  # (E_loc, cap_e)
    evalid = eidx < e_bounds[1:, None]
    rows = torch.where(evalid, mpool[eidx.clamp(max=n_pool - 1)].long(), n_pool)
    xe = pool[rows.clamp(max=n_pool - 1)] * evalid[..., None]

    ye = _expert_ffn(xe.to(xf.dtype), moe, cfg)
    if tp_axis is not None:  # d_expert over the TP axis: sum the contraction
        ye = tp_axis.all_sum(ye)

    # ---- route back: scatter to pool rows (row n_pool takes the drops),
    # inverse all_to_all
    out_pool = torch.zeros((n_pool + 1, d), dtype=xf.dtype, device=dev)
    out_pool[rows.reshape(-1)] = (ye * evalid[..., None]).reshape(-1, d)
    back = a2a(out_pool[:n_pool].reshape(n_shards, C, d))  # source-bucket layout

    # ---- scatter to slots (row A takes the drops), combine top-k
    out_flat = torch.zeros((A + 1, d), dtype=xf.dtype, device=dev)
    tgt = torch.where(valid, bslots.clamp(max=A - 1), A)
    out_flat[tgt.reshape(-1).long()] = back.reshape(-1, d)
    out = (out_flat[:A].reshape(T, K, d) * w[..., None].to(xf.dtype)).sum(1)
    return out, aux, send_counts.to(torch.int32)


def _make_a2a(mesh, axis_names, hierarchical: bool = False):
    """Bucket exchange over the expert axes (``lax.all_to_all``, tiled, on
    axis 0). ``hierarchical=True`` on two axes: the same permutation as
    two single-axis exchanges,

        r[(d1,d2)][(s1,s2)] = x[(s1,s2)][(d1,d2)]
          == a2a_axis1(a2a_axis0(x.reshape(S1, S2, C)))

    each over contiguous groups, with the same total bytes. Either
    permutation is its own inverse, which is its backward
    (``parallel.exchange``)."""
    if hierarchical and isinstance(axis_names, (tuple, list)) and len(axis_names) == 2:
        g1, g2 = (axis_group(mesh, a) for a in axis_names)

        def flat(x):
            y = g1.all_to_all(x.reshape(g1.size, g2.size, *x.shape[1:]))
            y = g2.all_to_all(y.transpose(0, 1).contiguous()).transpose(0, 1)
            return y.reshape(x.shape)
    else:
        flat = axis_group(mesh, axis_names).all_to_all
    return lambda x: par.exchange(x, flat)


def local_tokens(x, axes: Axes | None):
    """This rank's block of the global (B, S, d) tokens (module docstring)."""
    if axes is None or axes.expert_size == 1:
        return x
    B, S, _ = x.shape
    bax = fit_batch_axes(B, axes)
    if bax is not None:
        x = par.split(x, 0, axes, bax)
    if S % axes.model_size == 0:
        x = par.split_seq(x, axes)
    return x


def shard_params(moe: MoE, axes: Axes | None) -> MoE:
    """This rank's experts (views) and the router (module docstring)."""
    if axes is None or axes.expert_size == 1:
        return moe
    e_loc = moe.wi.shape[0] // axes.expert_size
    lo = axis_group(axes.mesh, axes.expert).index * e_loc
    return MoE(moe.router, *(t[lo:lo + e_loc] for t in (moe.wi, moe.wg, moe.wo)))


def _check_slice(moe: MoE, cfg, n_experts: int, d_expert: int, what: str) -> None:
    want = (n_experts, cfg.d_model, d_expert)
    if tuple(moe.wi.shape) != want:
        raise ValueError(f"{what} takes experts of {want} a rank, not {tuple(moe.wi.shape)}: "
                         f"the layout of rules.param_specs(mode='decode')")


def moe_forward(x, moe: MoE, cfg, axes: Axes | None = None, *, use_pallas: bool = True,
                tp_axis: str | None = None):
    """x: (B, S, d), on a mesh this rank's block of the tokens and ``moe``
    its experts (module docstring). Returns (out (B, S, d), aux scalar).

    ``use_pallas`` picks the sort's path (``keyenc.stable_argsort``,
    ``merge_padded_runs_kv``): True, the default here (``repro``'s is
    False, ``lax.sort``), takes the bitonic kernels on a CUDA tensor;
    both give the same bits.

    ``tp_axis`` (EP x TP, ``repro``'s decode of ``cfg.decode_moe_ep``):
    ``moe`` holds this rank's experts over ``axes.expert`` and its slice of
    d_expert over the mesh axis ``tp_axis``; x is the rank's block of the
    batch with the sequence whole (the ranks of ``tp_axis`` hold the same
    tokens and dispatch them alike), and the expert FFN's partial outputs
    are summed over ``tp_axis``."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    mesh = axes is not None and axes.mesh is not None
    tp = par.group(axes, tp_axis) if tp_axis is not None and mesh else None
    if tp is not None:
        shards = axes.expert_size
        _check_slice(moe, cfg, cfg.n_experts // shards, cfg.d_expert // tp.size,
                     "EP x TP MoE")
    if axes is None or axes.expert_size == 1:
        out, aux, _ = _dispatch_body(xf, moe, cfg, n_shards=1, shard_id=0,
                                     a2a=lambda t: t, use_pallas=use_pallas, tp_axis=tp)
        if mesh:  # batch blocks: their mean
            aux = par.aux_mean(aux, axes)
        return out.reshape(B, S, d), aux

    group = axis_group(axes.mesh, axes.expert)
    if moe.wi.shape[0] * group.size != cfg.n_experts:
        raise ValueError(f"a rank of {group.size} expert shards holds "
                         f"{cfg.n_experts // group.size} experts, not {moe.wi.shape[0]}: "
                         f"pass shard_params(moe, axes)")
    out, aux, _ = _dispatch_body(
        xf, moe, cfg, n_shards=group.size, shard_id=group.index,
        a2a=_make_a2a(axes.mesh, axes.expert, hierarchical=cfg.hierarchical_a2a),
        use_pallas=use_pallas, tp_axis=tp,
    )
    return out.reshape(B, S, d), par.aux_mean(aux, axes)  # the mean over the mesh


def moe_forward_decode(x, moe: MoE, cfg, axes: Axes | None = None):
    """Decode-time MoE (S == 1): each token gathers exactly its top-k
    experts' weight slices, so the FLOPs are the active experts' and the
    traffic is reading those slices. Under a mesh this is expert tensor
    parallelism, ``repro``'s serve-mode rule: ``moe`` holds every expert
    with this rank's slice of d_expert over "model", x is the rank's rows
    (the ranks of "model" hold the same), and the partial outputs are
    summed over "model", the all-reduce GSPMD inserts in ``repro``."""
    B, S, d = x.shape
    g = par.group(axes, axes.model) if axes is not None else None
    if g is not None:
        _check_slice(moe, cfg, cfg.n_experts, cfg.d_expert // g.size, "expert-TP decode")
    xf = x.reshape(-1, d)
    w, ids, aux = _router(xf, moe.router, cfg)
    ids = ids.long()
    h = torch.einsum("td,tkdf->tkf", xf, moe.wi[ids])  # (T, K, de)
    gate = torch.einsum("td,tkdf->tkf", xf, moe.wg[ids])
    y = torch.einsum("tkf,tkfd->tkd", _act(gate, cfg.act) * h, moe.wo[ids])
    out = par.reduce_from((y * w[..., None].to(xf.dtype)).sum(1), axes)
    return out.reshape(B, S, d), aux


# ------------------------------------------------------------------ oracle


def moe_ref(x, moe: MoE, cfg):
    """Dense one-hot reference (no capacity drops)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    w, ids, aux = _router(xf, moe.router, cfg)
    onehot = F.one_hot(ids.long(), cfg.n_experts).to(xf.dtype)  # (T, K, E)
    combine = (onehot * w[..., None].to(xf.dtype)).sum(1)  # (T, E)
    h = torch.einsum("td,edf->tef", xf, moe.wi)
    g = torch.einsum("td,edf->tef", xf, moe.wg)
    y = torch.einsum("tef,efd->ted", _act(g, cfg.act) * h, moe.wo)
    out = (y * combine[..., None]).sum(1)
    return out.reshape(B, S, d), aux
