"""The comparisons that decide ``correct``: their arithmetic, apart from
the references that give the wanted answers."""
from __future__ import annotations


def logits(want, got, served) -> tuple:
    """(logit_err, token_gap) of one served prompt, each as a share of the
    root mean square of the reference's logits ``want`` (vocab,):
    the root mean square of ``got - want``, and how far the reference's
    logit of the served token lies below its best."""
    scale = float(want.pow(2).mean().sqrt())
    err = float((got.float().to(want.device) - want).pow(2).mean().sqrt()) / scale
    gap = float(want.max() - want[int(served)]) / scale
    return err, gap
