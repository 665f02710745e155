"""Optimizers: AdamW and Adafactor, the schedule and global-norm clipping.

The port of ``repro/optim/adamw.py``, function for function. ``repro``'s
states are pytrees mirroring the parameters; here parameters, gradients
and states are dicts of tensors keyed by the model's ``state_dict``
names, and an update writes the parameters and states in place under
``torch.no_grad()`` (``torch.optim.AdamW`` orders the decay and the step
otherwise, so its bits would drift from ``repro``'s). The math of every
update is float32, cast back to the parameter's dtype; states are held in
``state_dtype``.

``repro`` stacks each period position of a config segment over the
segment's count, ``(count, ...)``, and the port holds one tensor per
layer (``convert.params_from_jax``). AdamW is elementwise and does not
see the difference. Adafactor does, twice: whether a leaf's second
moment is factored is decided on the stacked shape, and its relative
step clip takes the RMS of the update over the whole stacked leaf, so
over every layer of the segment. ``apply_updates`` therefore takes the
per-layer names ``repro`` stacks together (``segment_groups``).

On a sharded model (``axes`` with a mesh) a rank holds its block of each
parameter and gradient. The global norm is the sum of squares of every
leaf's block, summed over the axes that shard the leaf, so that each
element counts once whatever its replicas. AdamW is ZeRO-1: where a
rank's m and v are a block of its parameter's along one dimension
(``rules.opt_state_specs`` put "data" there), it updates that block of
the parameter and gathers the blocks over "data" into the parameter;
every replica then holds the same bits.

Adafactor is ZeRO-1 too: a rank holds, between steps, its block of each
``vr``, ``vc`` and ``v`` by ``rules.opt_state_specs`` (the state's spec
from its parameter's, "data" on the largest replicated dimension of
``repro``'s stacked state). A step gathers the rank's blocks over the
axes the state has and its parameter's block lacks (``_relayout``),
updates the parameter's block whole, and keeps its block of the new
states. Every rank that holds a parameter block updates it from the same
bits, so replicas stay equal with no gather of the parameters. A mean
over a dimension the parameter's spec shards (``vr``'s over the last,
``vc``'s over the second to last, the denominator's ``vr.mean(-1)``) is
summed over the axes that shard it (``_mean``), and the relative step
clip takes the RMS of the update over the whole stacked leaf: every
layer of the segment (``segment_groups``) and every rank that shards the
leaf, never its replicas (as ``_global_norm`` counts). Where ``repro``
puts "data" on the stack dimension of a state (a stacked ``vr`` whose
only replicated dimension is the stack, as MLA's ``wo``: (count, H v)
over (None, "model")), the port, which holds one tensor a layer, holds
that state whole over "data" (``rules._strip``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.sharding import parallel as par
from repro_torch.sharding.rules import spec_axes


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"
    # adafactor
    factored_min_dim: int = 128


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup + cosine decay with a 0.1 floor, in float32 (a 0-d
    CPU tensor); lr_at(0) == 0."""
    step = _f32(step)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.clamp(warm, max=1.0) * torch.clamp(cos, min=0.1)


def segment_groups(model_cfg, names) -> list[tuple[str, ...]]:
    """The per-layer parameter names that ``repro`` stacks into one leaf:
    for each segment, period position and leaf name, the names
    ``layers.<i>.<leaf>`` of its ``count`` layers, in order. A segment of
    count 1 is a group of one (``repro`` stacks it as (1, ...))."""
    names = list(names)
    groups: dict = {}
    layer = 0
    for s, (period, count) in enumerate(model_cfg.segments):
        for _ in range(count):
            for j in range(len(period)):
                prefix = f"layers.{layer}."
                for n in names:
                    if n.startswith(prefix):
                        groups.setdefault((s, j, n[len(prefix):]), []).append(n)
                layer += 1
    return [tuple(g) for g in groups.values()]


def _global_norm(tree: dict, axes=None, specs=None) -> torch.Tensor:
    if specs is None:
        return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tree.values()))
    sums: dict = {}  # by the axes that shard the leaf
    for name, t in tree.items():
        names = spec_axes(specs[name])
        sq = torch.sum(torch.square(t.float()))
        sums[names] = sums[names] + sq if names in sums else sq
    total = 0.0
    for names, sq in sums.items():
        g = par.group(axes, names)
        total = total + (sq if g is None else g.all_sum(sq))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float, inplace: bool = False, axes=None,
                        specs=None):
    """Returns (clipped grads, the global norm before clipping). With
    ``inplace`` the float32 gradients are scaled where they are (the same
    bits) and returned. ``axes`` and ``specs``: the blocks of a sharded
    model's gradients (module docstring)."""
    norm = _global_norm(grads, axes, specs)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    if inplace:
        for g in grads.values():
            if g.dtype != torch.float32:
                raise TypeError(f"in-place clipping takes float32 gradients, not {g.dtype}")
            g.mul_(scale)
        return grads, norm
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


# -------------------------------------------------------------------- AdamW


def init_adamw_state(params: dict, cfg: OptConfig, shapes: dict | None = None) -> dict:
    """Zeroed m and v, of each parameter's shape or of ``shapes[name]``
    (ZeRO-1: a block of it along one dimension)."""
    dt = getattr(torch, cfg.state_dtype)

    def zeros(k, p):
        return torch.zeros(p.shape if shapes is None else shapes[k], dtype=dt, device=p.device)

    return {"m": {k: zeros(k, p) for k, p in params.items()},
            "v": {k: zeros(k, p) for k, p in params.items()}}


def _zero_dim(p, m) -> int | None:
    """The dimension along which the state ``m`` is a block of ``p``."""
    if m.shape == p.shape:
        return None
    return next(i for i, (a, b) in enumerate(zip(p.shape, m.shape)) if a != b)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, step, cfg: OptConfig,
                 axes=None) -> None:
    """One AdamW step on every leaf, in place: bias correction with
    t = step + 1, decoupled decay on every leaf. A leaf whose m and v are
    a block of it (ZeRO-1) updates that block and gathers the blocks over
    "data" (module docstring)."""
    lr = float(lr_at(step, cfg))
    t = _f32(step) + 1.0
    bc1 = float(1 - cfg.b1 ** t)
    bc2 = float(1 - cfg.b2 ** t)
    dt = getattr(torch, cfg.state_dtype)
    data = par.group(axes, "data") if axes is not None else None
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        dim = _zero_dim(p, m)
        g, w = grads[k], p
        if dim is not None:
            n = m.shape[dim]
            g, w = g.narrow(dim, data.index * n, n), p.narrow(dim, data.index * n, n)
        gf = g.float()
        pf = w.float()
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps) + cfg.weight_decay * pf
        new = (pf - lr * delta).to(p.dtype)
        if dim is None:
            p.copy_(new)
        else:
            p.copy_(torch.cat(data.all_gather(new).unbind(0), dim=dim))
        m.copy_(mf.to(dt))
        v.copy_(vf.to(dt))


# ---------------------------------------------------------------- Adafactor


def _factored(shape, cfg: OptConfig) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.factored_min_dim
            and shape[-2] >= cfg.factored_min_dim)


def _leaf_groups(names, groups) -> list[tuple[tuple[str, ...], bool]]:
    """(names, stacked) for every leaf of ``repro``'s tree: the stacked
    groups first, then each other name alone."""
    out = [(tuple(g), True) for g in (groups or ())]
    seen = {n for g, _ in out for n in g}
    return out + [((k,), False) for k in names if k not in seen]


def adafactor_shapes(shapes: dict, cfg: OptConfig, groups=None) -> dict:
    """{name: {"vr": shape, "vc": shape} | {"v": shape}}: Adafactor's state
    of parameters of ``shapes`` (whole), factored where ``repro``'s
    stacked leaf is (``_factored`` of (count, ...) for a group of
    ``segment_groups``)."""
    out = {}
    for names, stacked in _leaf_groups(shapes, groups):
        shape = tuple(shapes[names[0]])
        full = (len(names),) + shape if stacked else shape
        for k in names:
            s = tuple(shapes[k])
            if not _factored(full, cfg):
                out[k] = {"v": s}
            elif len(s) < 2:
                raise NotImplementedError(
                    f"{k}: a segment of {len(names)} layers stacks this 1-D leaf into a "
                    f"factored {full}, whose second moments do not split per layer")
            else:
                out[k] = {"vr": s[:-1], "vc": s[:-2] + s[-1:]}
    return out


def init_adafactor_state(params: dict, cfg: OptConfig, groups=None, shapes=None) -> dict:
    """Zeroed second moments; ``shapes``: a sharded model's blocks of them
    (``train.step.state_shapes``), else ``adafactor_shapes`` of the
    parameters."""
    dt = getattr(torch, cfg.state_dtype)
    if shapes is None:
        shapes = adafactor_shapes({k: p.shape for k, p in params.items()}, cfg, groups)
    return {"v": {k: {kind: torch.zeros(s, dtype=dt, device=params[k].device)
                      for kind, s in shapes[k].items()} for k in params}}


def _dim_axes(spec, dim: int) -> tuple:
    """The mesh axes that shard dimension ``dim`` of a leaf with ``spec``."""
    return () if spec is None else par._entry(spec, dim)


def _mean(t, dim: int, names, axes):
    """``t.mean(dim)`` of the whole leaf from this rank's block, ``dim``
    split over ``names``: the block's sums summed over them."""
    g = par.group(axes, names) if names else None
    if g is None:
        return t.mean(dim)
    return g.all_sum(t.sum(dim)) / (t.shape[dim] * g.size)


def _relayout(t, src, dst, axes):
    """A rank's block of a leaf by ``dst`` from its block by ``src``: each
    dimension whose axes differ gathered whole first, then sliced by
    ``dst`` (collective)."""
    if src is None or tuple(src) == tuple(dst):
        return t
    moved = [d for d in range(t.dim()) if _dim_axes(src, d) != _dim_axes(dst, d)]
    for d in moved:
        if _dim_axes(src, d):
            t = par.gather_leaf(t, (None,) * d + (_dim_axes(src, d),), axes)
    for d in moved:
        if _dim_axes(dst, d):
            t = par.shard_leaf(t, (None,) * d + (_dim_axes(dst, d),), axes)
    return t


def _factored_spec(spec, kind: str):
    """The layout of a factored state over a parameter block of ``spec``."""
    if spec is None:
        return None
    spec = tuple(spec)
    return spec[:-1] if kind == "vr" else spec[:-2] + spec[-1:]


@torch.no_grad()
def adafactor_update(params: dict, grads: dict, state: dict, step, cfg: OptConfig,
                     groups=None, axes=None, specs=None, state_specs=None) -> None:
    """One Adafactor step in place (Shazeer-Stern beta2, factored second
    moments, relative step-size clipping over each stacked leaf).
    ``axes``, ``specs`` and ``state_specs``: a sharded model's, its
    parameters' and its states' (ZeRO-1; module docstring)."""
    lr = float(lr_at(step, cfg))
    t = _f32(step) + 1.0
    beta2 = float(1.0 - t ** -0.8)
    dt = getattr(torch, cfg.state_dtype)
    eps = 1e-30
    sharded = specs is not None and axes is not None and axes.mesh is not None
    for names, _ in _leaf_groups(params, groups):
        upds, sq, count = [], 0.0, 0
        for k in names:
            pspec = specs[k] if sharded else None
            gf = grads[k].float()
            g2 = gf.square().add_(eps)
            s = state["v"][k]
            own = state_specs["v"][k] if sharded else {}
            if "vr" in s:
                rs, cs = _factored_spec(pspec, "vr"), _factored_spec(pspec, "vc")
                old_r = _relayout(s["vr"], own.get("vr"), rs, axes).float()
                old_c = _relayout(s["vc"], own.get("vc"), cs, axes).float()
                row = _mean(g2, -1, _dim_axes(pspec, -1), axes)
                col = _mean(g2, -2, _dim_axes(pspec, -2), axes)
                del g2  # the leaf's temporaries one at a time: a large leaf is GBs
                vr = beta2 * old_r + (1 - beta2) * row
                vc = beta2 * old_c + (1 - beta2) * col
                vr_mean = _mean(vr, -1, _dim_axes(rs, -1), axes)
                denom = vr[..., :, None] * vc[..., None, :]
                denom.div_(torch.clamp(vr_mean[..., None, None], min=eps))
                upd = denom.clamp_(min=eps).rsqrt_().mul_(gf)
                s["vr"].copy_(_relayout(vr.to(dt), rs, own.get("vr", rs), axes))
                s["vc"].copy_(_relayout(vc.to(dt), cs, own.get("vc", cs), axes))
            else:
                old = _relayout(s["v"], own.get("v"), pspec, axes).float()
                v = (beta2 * old).add_(g2.mul_(1 - beta2))
                del g2
                upd = torch.clamp(v, min=eps).rsqrt_().mul_(gf)
                s["v"].copy_(_relayout(v.to(dt), pspec, own.get("v", pspec), axes))
            upds.append(upd)
            sq = sq + torch.square(upd).sum()
            count += upd.numel()
        if sharded:  # over the ranks that shard the leaf (every layer of it shares one spec)
            g = par.group(axes, spec_axes(specs[names[0]]))
            if g is not None:
                sq, count = g.all_sum(sq), count * g.size
        # relative step-size clipping (RMS(update) <= 1) over the stacked leaf
        rms = torch.sqrt(sq / count + eps)
        for k, upd in zip(names, upds):
            p = params[k]
            pf = p.float()
            upd.div_(torch.clamp(rms, min=1.0)).add_(pf * cfg.weight_decay).mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(upd)
            else:
                p.copy_((pf - upd).to(p.dtype))


# ------------------------------------------------------------------ facade


def init_opt_state(params: dict, cfg: OptConfig, groups=None, shapes=None) -> dict:
    """``shapes``: the ZeRO-1 blocks of the states on a sharded model
    (``train.step.state_shapes``)."""
    if cfg.name == "adafactor":
        return init_adafactor_state(params, cfg, groups, shapes)
    return init_adamw_state(params, cfg, shapes)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, step, cfg: OptConfig,
                  groups=None, axes=None, specs=None, state_specs=None):
    """Clip the gradients to ``cfg.clip_norm``, then update ``params`` and
    ``state`` in place. ``groups``: the names stacked into one leaf
    (``segment_groups``; only Adafactor reads them). Float32 gradients
    are clipped in place (the train step passes its own sums; a full
    clipped copy would cost another float32 copy of the model). ``axes``,
    ``specs`` and ``state_specs``: a sharded model's, its parameters' and
    its optimizer states' (module docstring). Returns (params, state, the
    global norm before clipping)."""
    f32 = all(g.dtype == torch.float32 for g in grads.values())
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, inplace=f32, axes=axes,
                                       specs=specs)
    if cfg.name == "adafactor":
        adafactor_update(params, grads, state, step, cfg, groups, axes, specs, state_specs)
    else:
        adamw_update(params, grads, state, step, cfg, axes)
    return params, state, gnorm
