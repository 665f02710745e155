"""The one generator of the benchmark's traffic.

A traffic mix is a JSON file of parameters in ``bench/traffic/``, read by
name. Everything it makes is drawn on the device from the run's seed, in
a few large calls, and the same seed always makes the same inputs:

* ``"kind": "sort"``: the configuration's ``keys_per_card`` keys of ``dtype`` from one of the
  paper's distributions (PGX.D, arXiv:1611.00463, Fig. 4), a ``pool`` of
  that many distinct inputs cycled in order by one client in a closed
  loop; ``want`` is the sort's ``"values"`` or ``"order"``; ``ranks``
  processes, one a card, each sort its own shard.
* ``"kind": "prefill"``: ``pool`` prompts of ``prompt_tokens`` token ids,
  uniform over the configuration's vocabulary, ``batch`` prompts a
  request, sent by one client in a closed loop.
"""
from __future__ import annotations

from benchlib import stats

DISTRIBUTIONS = ("uniform", "normal", "right_skewed", "exponential")


def check_loop(traffic: dict) -> None:
    """The drivers run one client in a closed loop; refuse another mix
    rather than run it as that."""
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError(f"traffic {traffic}: the drivers run one client in a closed loop")


def generator(seed: int, device, *labels):
    import torch

    return torch.Generator(device=device).manual_seed(stats.derive(seed, *labels))


def keys(distribution: str, n: int, dtype: str, gen, device):
    """n keys from the paper's Fig. 4 inputs (the pattern of the JAX
    package's ``benchmarks/common.py``, here in PyTorch on the device):

    uniform      u ~ U(0, 1)
    normal       N(0, 1)
    right_skewed floor(u^6 * 64): 64 values, half of the keys 0
    exponential  floor(Exp(1) * 8)

    cast to ``dtype`` (``"float32"`` or ``"int32"``)."""
    import torch

    if distribution == "uniform":
        x = torch.rand(n, generator=gen, device=device)
    elif distribution == "normal":
        x = torch.randn(n, generator=gen, device=device)
    elif distribution == "right_skewed":
        x = torch.floor(torch.rand(n, generator=gen, device=device).pow_(6).mul_(64))
    elif distribution == "exponential":
        x = torch.floor(torch.empty(n, device=device).exponential_(1.0, generator=gen).mul_(8))
    else:
        raise KeyError(f"unknown distribution {distribution!r}: one of {DISTRIBUTIONS}")
    return x.to(getattr(torch, dtype))


def sort_input(traffic: dict, n: int, seed: int, index: int, rank: int, device):
    """Input ``index`` of the pool: rank ``rank``'s shard of ``n`` keys."""
    gen = generator(seed, device, "sort-input", index, rank)
    return keys(traffic["distribution"], n, traffic["dtype"], gen, device)


def prompts(traffic: dict, vocab: int, seed: int, device):
    """The pool of prompts: (pool, batch, prompt_tokens) int64 token ids."""
    import torch

    gen = generator(seed, device, "prompts")
    shape = (traffic["pool"], traffic["batch"], traffic["prompt_tokens"])
    return torch.randint(0, vocab, shape, generator=gen, device=device)
