"""Cross-entropy loss over the (sharding-padded) vocab: ``repro/train/loss.py``.

Under a mesh the logits are vocab-parallel: a rank holds its block of the
padded vocabulary's columns, and gathering them is not an option (at
16,384 tokens and a vocabulary of 102,400 the float32 logits of a
micro-step are 6.7 GB). The statistics a token needs are reduced over
"model" instead: the maximum (the block maxima, all-gathered), the sum
of exponentials and the target's logit (each summed). The gradient of a
rank's columns is its block of softmax - onehot, as the one-rank
gradient's columns.

Along the batch axes each rank holds a block of the batch, and the loss
is the global batch's: the masked sums over the rank's tokens divided by
the count of unmasked labels over the whole batch. What a rank returns
and differentiates is its block's share; the shares of the batch blocks
sum to the loss (``sharding/parallel.py``). The metrics are the global
batch's on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.sharding import parallel as par


def cross_entropy(logits, labels, real_vocab: int, z_coef: float = 1e-4, axes=None):
    """logits: (B, S, Vp) any float dtype; labels: (B, S) integer with -1 =
    ignore. Padded vocab columns are masked with -1e30; the statistics are
    float32. Returns (loss + zloss, {"nll", "zloss", "accuracy"}). With a
    mesh in ``axes``: logits over this rank's block of the vocabulary,
    labels of its batch block, the first value its share (module
    docstring)."""
    if axes is not None and axes.mesh is not None:
        return _sharded(logits, labels, real_vocab, z_coef, axes)
    Vp = logits.shape[-1]
    col_ok = torch.arange(Vp, device=logits.device) < real_vocab
    lf = torch.where(col_ok, logits.float(), -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = lse - gold
    mask = (labels >= 0).float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / denom
    zloss = z_coef * ((lse * mask) ** 2).sum() / denom
    acc = ((lf.argmax(-1) == labels).float() * mask).sum() / denom
    return loss + zloss, {"nll": loss, "zloss": zloss, "accuracy": acc}


def _global_max(x, g):
    return x if g is None else g.all_gather(x).amax(0)


class _LseGold(torch.autograd.Function):
    """(logsumexp, target logit) of each token over the vocabulary blocks
    of "model"; backward, this block of softmax * dlse + onehot * dgold."""

    @staticmethod
    def forward(ctx, lf, labels, first, g):
        m = _global_max(lf.amax(-1), g)
        se = torch.exp(lf - m[..., None]).sum(-1)
        lse = m + torch.log(se if g is None else g.all_sum(se))
        local = labels.long() - first
        mine = (local >= 0) & (local < lf.shape[-1])
        at = local.clamp(0, lf.shape[-1] - 1)[..., None]
        gold = torch.where(mine, lf.gather(-1, at)[..., 0], 0.0)
        if g is not None:
            gold = g.all_sum(gold)
        ctx.save_for_backward(lf, lse, at, mine)
        return lse, gold

    @staticmethod
    def backward(ctx, d_lse, d_gold):
        lf, lse, at, mine = ctx.saved_tensors
        grad = torch.exp(lf - lse[..., None]) * d_lse[..., None]
        grad.scatter_add_(-1, at, torch.where(mine, d_gold, 0.0)[..., None])
        return grad, None, None, None


def _sharded(logits, labels, real_vocab, z_coef, axes):
    gm = par.group(axes, axes.model)
    gb = par.group(axes, axes.batch)
    Vl = logits.shape[-1]
    first = gm.index * Vl if gm is not None else 0
    col_ok = first + torch.arange(Vl, device=logits.device) < real_vocab
    lf = torch.where(col_ok, logits.float(), -1e30)
    lse, gold = _LseGold.apply(lf, labels, first, gm)
    nll = lse - gold
    mask = (labels >= 0).float()
    with torch.no_grad():
        count = mask.sum()
        denom = torch.clamp_min(count if gb is None else gb.all_sum(count), 1.0)
        # the first index of the maximum: the first block holding it, its first index
        block_max, block_arg = lf.max(-1)
        if gm is not None:
            block_max, block_arg = gm.all_gather(block_max), gm.all_gather(block_arg + first)
            block_arg = block_arg.gather(0, block_max.argmax(0)[None])[0]
        right = ((block_arg == labels).float() * mask).sum()
    loss = (nll * mask).sum() / denom
    zloss = z_coef * ((lse * mask) ** 2).sum() / denom
    stats = torch.stack([loss.detach(), zloss.detach(), right / denom])
    if gb is not None:
        stats = gb.all_sum(stats)
    return loss + zloss, {"nll": stats[0], "zloss": stats[1], "accuracy": stats[2]}
