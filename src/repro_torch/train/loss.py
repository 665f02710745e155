"""Cross-entropy loss over the (sharding-padded) vocab: ``repro/train/loss.py``."""
from __future__ import annotations

import torch


def cross_entropy(logits, labels, real_vocab: int, z_coef: float = 1e-4):
    """logits: (B, S, Vp) any float dtype; labels: (B, S) integer with -1 =
    ignore. Padded vocab columns are masked with -1e30; the statistics are
    float32. Returns (loss + zloss, {"nll", "zloss", "accuracy"})."""
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
