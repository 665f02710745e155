"""Training step: micro-batched gradient accumulation, the rematerialized
model forward, one optimizer update: ``repro/train/step.py``.

``repro`` scans over the micro-batches with the float32 gradient sum as
the carry; here a Python loop takes each micro-batch's gradients with
``torch.autograd.grad`` (never through ``.grad``, which would add bf16
gradients in bf16) and adds them to sums held in ``accum_dtype``. The
update then divides by the number of micro-batches, clips and steps the
optimizer in place (``optim/adamw.py``). Parameters and optimizer states
are dicts of tensors keyed by the model's ``state_dict`` names; the
parameters are the model's own, so the model sees every update.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import Model
from repro_torch.optim import adamw as opt_lib
from repro_torch.train.loss import cross_entropy


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_lib.OptConfig = opt_lib.OptConfig()
    accum_dtype: str = "float32"
    aux_coef: float = 0.01
    grad_compression: str = "none"  # none | int8 (see optim/compress.py)


def make_loss_fn(model: Model, tcfg: TrainConfig):
    """loss_fn(micro) -> (total loss, metrics) on the model's parameters."""
    cfg = model.cfg

    def loss_fn(micro):
        logits, _, aux = model(micro)
        loss, metrics = cross_entropy(logits, micro["labels"], cfg.vocab)
        total = loss + tcfg.aux_coef * aux
        metrics = dict(metrics, aux=aux, loss=total)
        return total, metrics

    return loss_fn


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

    def train_step(params: dict, opt_state: dict, step, batch: dict):
        batch = _to_device(batch, model.device)
        accum = next(iter(batch.values())).shape[0]
        names, leaves = list(params), list(params.values())
        gsum = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves]
        per_micro = []
        for a in range(accum):
            with torch.enable_grad():
                total, metrics = loss_fn({k: v[a] for k, v in batch.items()})
                grads = torch.autograd.grad(total, leaves)
            with torch.no_grad():
                for s, g in zip(gsum, grads):
                    s.add_(g.to(acc_dt))
            del grads, total
            per_micro.append({k: v.detach().float() for k, v in metrics.items()})
        with torch.no_grad():
            for s in gsum:
                s.div_(accum)
        params, opt_state, gnorm = opt_lib.apply_updates(
            params, dict(zip(names, gsum)), opt_state, step, tcfg.opt, groups)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
        metrics["grad_norm"] = gnorm
        metrics["lr"] = opt_lib.lr_at(step, tcfg.opt)
        return params, opt_state, metrics

    return train_step


def init_train_state(model: Model, tcfg: TrainConfig):
    """(params, opt_state): the model's parameters (drawn from the seed the
    model was built with) and a zeroed optimizer state on their devices."""
    params = dict(model.named_parameters())
    groups = opt_lib.segment_groups(model.cfg, params)
    return params, opt_lib.init_opt_state(params, tcfg.opt, groups)
