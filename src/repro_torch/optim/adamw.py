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
every replica then holds the same bits. Adafactor is refused under a
mesh (``models.model.check_sharded``, ROADMAP.md §1 item 11.2).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import not_ported
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


def _leaf_groups(params: dict, groups) -> list[tuple[tuple[str, ...], bool]]:
    """(names, stacked) for every leaf of ``repro``'s tree: the stacked
    groups first, then each other name alone."""
    out = [(tuple(g), True) for g in (groups or ())]
    seen = {n for g, _ in out for n in g}
    return out + [((k,), False) for k in params if k not in seen]


def _stacked_shape(params: dict, names, stacked: bool) -> tuple:
    shape = tuple(params[names[0]].shape)
    return (len(names),) + shape if stacked else shape


def init_adafactor_state(params: dict, cfg: OptConfig, groups=None) -> dict:
    dt = getattr(torch, cfg.state_dtype)
    v = {}
    for names, stacked in _leaf_groups(params, groups):
        full = _stacked_shape(params, names, stacked)
        for k in names:
            p = params[k]
            if not _factored(full, cfg):
                v[k] = {"v": torch.zeros(p.shape, dtype=dt, device=p.device)}
            elif p.dim() < 2:
                raise NotImplementedError(
                    f"{k}: a segment of {len(names)} layers stacks this 1-D leaf into a "
                    f"factored {full}, whose second moments do not split per layer")
            else:
                v[k] = {"vr": torch.zeros(p.shape[:-1], dtype=dt, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=dt,
                                          device=p.device)}
    return {"v": v}


@torch.no_grad()
def adafactor_update(params: dict, grads: dict, state: dict, step, cfg: OptConfig,
                     groups=None) -> None:
    """One Adafactor step in place (Shazeer-Stern beta2, factored second
    moments, relative step-size clipping over each stacked leaf)."""
    lr = float(lr_at(step, cfg))
    t = _f32(step) + 1.0
    beta2 = float(1.0 - t ** -0.8)
    dt = getattr(torch, cfg.state_dtype)
    eps = 1e-30
    for names, _ in _leaf_groups(params, groups):
        upds, sq = [], 0.0
        for k in names:
            gf = grads[k].float()
            g2 = gf * gf + eps
            s = state["v"][k]
            if "vr" in s:
                vr = beta2 * s["vr"].float() + (1 - beta2) * g2.mean(-1)
                vc = beta2 * s["vc"].float() + (1 - beta2) * g2.mean(-2)
                denom = (vr[..., :, None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None], min=eps))
                upd = gf * torch.rsqrt(torch.clamp(denom, min=eps))
                s["vr"].copy_(vr.to(dt))
                s["vc"].copy_(vc.to(dt))
            else:
                v = beta2 * s["v"].float() + (1 - beta2) * g2
                upd = gf * torch.rsqrt(torch.clamp(v, min=eps))
                s["v"].copy_(v.to(dt))
            upds.append(upd)
            sq = sq + torch.square(upd).sum()
        # relative step-size clipping (RMS(update) <= 1) over the stacked leaf
        rms = torch.sqrt(sq / sum(u.numel() for u in upds) + eps)
        for k, upd in zip(names, upds):
            p = params[k]
            pf = p.float()
            upd = upd / torch.clamp(rms, min=1.0)
            p.copy_((pf - lr * (upd + cfg.weight_decay * pf)).to(p.dtype))


# ------------------------------------------------------------------ facade


def init_opt_state(params: dict, cfg: OptConfig, groups=None, shapes=None) -> dict:
    """``shapes``: AdamW's ZeRO-1 blocks on a sharded model
    (``train.step.state_shapes``)."""
    if cfg.name == "adafactor":
        if shapes is not None:
            raise not_ported("Adafactor under a mesh", "tp_mixers")
        return init_adafactor_state(params, cfg, groups)
    return init_adamw_state(params, cfg, shapes)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, step, cfg: OptConfig,
                  groups=None, axes=None, specs=None):
    """Clip the gradients to ``cfg.clip_norm``, then update ``params`` and
    ``state`` in place. ``groups``: the names stacked into one leaf
    (``segment_groups``; only Adafactor reads them). Float32 gradients
    are clipped in place (the train step passes its own sums; a full
    clipped copy would cost another float32 copy of the model). ``axes``
    and ``specs``: a sharded model's (module docstring). Returns (params,
    state, the global norm before clipping)."""
    f32 = all(g.dtype == torch.float32 for g in grads.values())
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, inplace=f32, axes=axes,
                                       specs=specs)
    if cfg.name == "adafactor":
        if specs is not None:
            raise not_ported("Adafactor under a mesh", "tp_mixers")
        adafactor_update(params, grads, state, step, cfg, groups)
    else:
        adamw_update(params, grads, state, step, cfg, axes)
    return params, state, gnorm
