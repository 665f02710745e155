"""Training step: micro-batched gradient accumulation, the rematerialized
model forward, one optimizer update: ``repro/train/step.py``.

``repro`` scans over the micro-batches with the float32 gradient sum as
the carry; here a Python loop runs each micro-batch's backward and adds
each parameter's gradient to its sum, held in ``accum_dtype``, as soon as
the backward has made it (a hook after the gradient's accumulation takes
it from ``.grad`` and leaves ``.grad`` None: bf16 gradients are never
added to one another in bf16 across micro-batches, and at most the
gradients the backward is still making are alive besides the sums). The
first micro-batch's gradients start the sums (no zeroed copy). The
update then divides by the number of micro-batches, clips and steps the
optimizer in place (``optim/adamw.py``). Parameters and optimizer states
are dicts of tensors keyed by the model's ``state_dict`` names; the
parameters are the model's own, so the model sees every update.

On a sharded model (``Model(cfg, axes=...)`` over a mesh) each rank takes
its block of the batch, and its loss is its share of the global batch's
(``train/loss.py``; the aux loss's share is 1 / batch blocks of it).
After the accumulation, each gradient sum is summed over the batch axes
("pod", "data") that its parameter's spec does not shard: a leaf sharded
over "data" (experts over ("data", "model")) already holds every block's
part, through the exchange's backward. The sums go one bucket a set of
axes, in chunks. The update is the optimizer's ZeRO-1 step
(``optim/adamw.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import Model
from repro_torch.optim import adamw as opt_lib
from repro_torch.sharding import parallel as par
from repro_torch.sharding import rules
from repro_torch.train.loss import cross_entropy

SUM_CHUNK_BYTES = 1 << 28  # the float32 gradients summed in one collective


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_lib.OptConfig = opt_lib.OptConfig()
    accum_dtype: str = "float32"
    aux_coef: float = 0.01
    grad_compression: str = "none"  # none | int8 (see optim/compress.py)


def make_loss_fn(model: Model, tcfg: TrainConfig):
    """loss_fn(micro) -> (total loss, metrics) on the model's parameters."""
    cfg = model.cfg
    axes = model.axes if model.sharded else None

    def loss_fn(micro):
        logits, _, aux = model(micro)
        loss, metrics = cross_entropy(logits, micro["labels"], cfg.vocab, axes=axes)
        if axes is None:
            total = loss + tcfg.aux_coef * aux
            return total, dict(metrics, aux=aux, loss=total)
        total = loss + tcfg.aux_coef * aux / axes.batch_size  # this rank's share
        whole = metrics["nll"] + metrics["zloss"] + tcfg.aux_coef * aux.detach()
        return total, dict(metrics, aux=aux, loss=whole)

    return loss_fn


@torch.no_grad()
def sum_over_batch_axes(grads: dict, specs: dict, axes) -> None:
    """Each gradient summed in place over the batch axes its spec does not
    shard: one bucket a set of axes, in chunks of SUM_CHUNK_BYTES."""
    buckets: dict = {}
    for name, spec in specs.items():
        names = tuple(a for a in axes.batch if a not in rules.spec_axes(spec))
        if par.group(axes, names) is not None:
            buckets.setdefault(names, []).append(grads[name])
    for names, leaves in buckets.items():
        g = par.group(axes, names)
        chunk, size = [], 0
        for t in [*leaves, None]:
            if t is not None:
                chunk.append(t)
                size += t.numel() * t.element_size()
            if chunk and (t is None or size >= SUM_CHUNK_BYTES):
                if len(chunk) == 1:  # a leaf of a chunk or more: summed where it is
                    g.all_sum_(chunk[0])
                else:
                    flat = g.all_sum_(torch.cat([c.reshape(-1) for c in chunk]))
                    for c, part in zip(chunk, flat.split([c.numel() for c in chunk])):
                        c.copy_(part.reshape(c.shape))
                chunk, size = [], 0


def _to_device(batch: dict, device) -> dict:
    from repro_torch.core.planner import as_tensor  # numpy (bfloat16 included) -> tensor

    return {k: as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model: Model, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, step, batch) -> (params,
    opt_state, metrics): ``params`` is ``dict(model.named_parameters())``,
    updated in place with ``opt_state``; ``batch`` holds numpy arrays or
    tensors with a leading (accum,) dim, moved to the model's device."""
    loss_fn = make_loss_fn(model, tcfg)
    acc_dt = getattr(torch, tcfg.accum_dtype)
    groups = opt_lib.segment_groups(model.cfg, dict(model.named_parameters()))
    axes = model.axes if model.sharded else None

    def train_step(params: dict, opt_state: dict, step, batch: dict):
        """``batch``: on a sharded model, this rank's block
        (``data.pipeline.batch_block``)."""
        batch = _to_device(batch, model.device)
        accum = next(iter(batch.values())).shape[0]
        names, leaves = list(params), list(params.values())
        gsum = [None] * len(leaves)

        def fold(i):
            def hook(p):  # p.grad: this micro-batch's whole gradient of leaf i
                g, p.grad = p.grad, None
                with torch.no_grad():
                    if gsum[i] is None:
                        gsum[i] = g.to(acc_dt).contiguous()
                    else:
                        gsum[i].add_(g.to(acc_dt))
            return hook

        for p in leaves:
            p.grad = None
        hooks = [p.register_post_accumulate_grad_hook(fold(i)) for i, p in enumerate(leaves)]
        per_micro = []
        try:
            for a in range(accum):
                with torch.enable_grad():
                    total, metrics = loss_fn({k: v[a] for k, v in batch.items()})
                    total.backward()
                del total
                per_micro.append({k: v.detach().float() for k, v in metrics.items()})
        finally:
            for h in hooks:
                h.remove()
        with torch.no_grad():
            for i, p in enumerate(leaves):
                if gsum[i] is None:  # a leaf the loss does not reach
                    gsum[i] = torch.zeros(p.shape, dtype=acc_dt, device=p.device)
            for s in gsum:
                s.div_(accum)
        grads = dict(zip(names, gsum))
        sspecs = None
        if axes is not None:
            sum_over_batch_axes(grads, model.specs, axes)
            sspecs = state_specs(model, tcfg)
        params, opt_state, gnorm = opt_lib.apply_updates(
            params, grads, opt_state, step, tcfg.opt, groups, axes=axes, specs=model.specs,
            state_specs=sspecs)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
        metrics["grad_norm"] = gnorm
        metrics["lr"] = opt_lib.lr_at(step, tcfg.opt)
        return params, opt_state, metrics

    return train_step


def init_train_state(model: Model, tcfg: TrainConfig):
    """(params, opt_state): the model's parameters (drawn from the seed the
    model was built with) and a zeroed optimizer state on their devices; on
    a sharded model this rank's blocks of the states, ZeRO-1 over "data"
    (``opt_state_specs``)."""
    params = dict(model.named_parameters())
    groups = opt_lib.segment_groups(model.cfg, params)
    if not model.sharded:
        return params, opt_lib.init_opt_state(params, tcfg.opt, groups)
    return params, opt_lib.init_opt_state(params, tcfg.opt, groups,
                                          shapes=state_shapes(model, tcfg))


def _whole_states(model: Model, tcfg: TrainConfig) -> dict:
    """The optimizer state's leaves of a sharded model, whole: AdamW's m
    and v of each parameter's shape, Adafactor's ``adafactor_shapes``."""
    shapes = model.global_shapes
    if tcfg.opt.name == "adafactor":
        groups = opt_lib.segment_groups(model.cfg, shapes)
        return {"v": opt_lib.adafactor_shapes(shapes, tcfg.opt, groups)}
    return {"m": shapes, "v": shapes}


def state_specs(model: Model, tcfg: TrainConfig) -> dict:
    """The specs of a sharded model's optimizer state (ZeRO-1)."""
    return rules.opt_state_specs(_whole_states(model, tcfg), model.specs, model.cfg,
                                 model.axes, zero=True)


def state_shapes(model: Model, tcfg: TrainConfig) -> dict:
    """{name: this rank's shape} of AdamW's m and v on a sharded model, or
    {name: {kind: this rank's shape}} of Adafactor's states."""
    specs = state_specs(model, tcfg)
    whole = _whole_states(model, tcfg)
    if "m" in specs:
        return {n: par.local_shape(whole["m"][n], s, model.axes) for n, s in specs["m"].items()}
    return {n: {k: par.local_shape(whole["v"][n][k], s, model.axes) for k, s in d.items()}
            for n, d in specs["v"].items()}
