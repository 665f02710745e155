"""Faults planted in the program underneath a run, for the tests that
see ``correct`` come out false (``test_bench_faults.py``):

answer    every sort's answer altered where it is produced: the first
          and last sorted keys swapped, and for ``want="order"`` the
          first two indices of the permutation too
token     each prefill's logits altered where they make the token: the
          served token becomes the one after the argmax
exchange  the mesh sort's bucket exchange left out: every rank merges
          its own buckets
"""
from __future__ import annotations


def _answer(put):
    import repro_torch

    orig = repro_torch.sort

    def sort(*args, **kwargs):
        out = orig(*args, **kwargs)
        keys = out.keys
        if keys.numel() > 1:
            keys[[0, -1]] = keys[[-1, 0]].clone()
        if out.meta.want == "order" and out.values.numel() > 1:
            out.values[[0, 1]] = out.values[[1, 0]].clone()
        return out

    put(repro_torch, "sort", sort)


def _token(put):
    from repro_torch.serve import engine

    orig = engine.make_prefill

    def make_prefill(model):
        inner = orig(model)

        def prefill(batch, seq_shard: bool = False):
            logits, caches = inner(batch, seq_shard)
            vocab = model.cfg.vocab
            last = logits[:, -1, :vocab]
            nxt = (last.argmax(-1) + 1) % vocab
            last.scatter_(-1, nxt[:, None], (last.max(-1).values + 1)[:, None])
            return logits, caches

        return prefill

    put(engine, "make_prefill", make_prefill)


def _exchange(put):
    from repro_torch.core import sample_sort

    put(sample_sort, "_exchange",
        lambda ag, grid, bounds, cap: sample_sort._gather_buckets(grid, bounds, cap)[0])


FAULTS = {"answer": _answer, "token": _token, "exchange": _exchange}


def apply(name: str, put=setattr) -> None:
    """Plant the fault ``name``; ``put(module, attribute, value)`` sets
    each patch (``monkeypatch.setattr`` in a test, undone after it)."""
    FAULTS[name](put)
