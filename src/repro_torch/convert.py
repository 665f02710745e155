"""Carry inputs and settings from ``repro`` to the port and results back.

For a sort, what crosses between the two packages is the configuration
(``SortConfig`` / ``SortLimits``, given as the plain dicts of
``dataclasses.asdict``), the input arrays, and the output. For a model it
is also the weights (``params_from_jax``), the optimizer states
(``opt_state_from_jax``) and the caches (``caches_to_numpy``). The tests
use these to feed both packages the same thing and compare the results as
numpy arrays. ``shard_state`` takes a rank's blocks of a state by the
sharding rules' specs, and ``gather_state`` puts the whole state back
together from every rank's blocks: with them a sharded model gets the
weights of ``repro``'s one-device model.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.planner import SortLimits, as_tensor
from repro_torch.core.result import SortOutput
from repro_torch.core.splitters import SortConfig


def config_from_dict(d: dict) -> SortConfig:
    return SortConfig(**d)


def limits_from_dict(d: dict) -> SortLimits:
    return SortLimits(**d)


def to_tensor(x, device) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on ``device``."""
    return as_tensor(x).to(device)


def to_numpy(t: torch.Tensor | None) -> np.ndarray | None:
    """A tensor as a host numpy array. bfloat16, which numpy lacks, comes
    back as its uint16 bit patterns."""
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def output_to_numpy(out: SortOutput) -> dict:
    """Everything a port ``SortOutput`` carries that ``repro`` has too."""
    return {
        "keys": to_numpy(out.keys),
        "values": to_numpy(out.values),
        "counts": np.asarray(out.counts),
        "send_counts": None if out.send_counts is None else np.asarray(out.send_counts),
        "overflowed": bool(out.overflowed),
        "retries": out.meta.retries,
        "config": out.meta.config,
    }


def _tensor(a) -> torch.Tensor:
    """``as_tensor`` keeping a 0-d leaf (a VLM's cross gate) 0-d."""
    return as_tensor(a).reshape(np.shape(a))


def _leaves(tree, prefix: str = ""):
    """(dotted path, array) for every leaf of a nested dict of arrays."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{prefix}.{key}" if prefix else key)
    else:
        yield prefix, np.asarray(tree)


def params_from_jax(cfg, params: dict) -> dict[str, torch.Tensor]:
    """``repro``'s parameter pytree (numpy or jax arrays) as a ``state_dict``
    of the port's ``Model`` (CPU tensors, bfloat16 included).

    The port names its parameters as the pytree's leaves. ``repro`` stacks
    each period position of a segment over the segment's count, ``(count,
    ...)``; the port holds one module per layer, ``layers.<i>``, in the
    order ``cfg.layer_list()`` gives, so each stacked leaf is split, and so
    are the encoder's (``params["encoder"]["segments"]``, in
    cfg.encoder_segments order) into ``encoder.layers.<i>``."""
    out = {}
    for key, tree in params.items():
        if key == "encoder":
            out.update(_split_segments(cfg.encoder_segments, tree["segments"], "encoder.layers"))
            out.update((name, _tensor(a)) for name, a in _leaves(tree["final_norm"],
                                                                 "encoder.final_norm"))
        elif key != "segments":
            out.update((name, _tensor(a)) for name, a in _leaves(tree, key))
    out.update(_split_segments(cfg.segments, params["segments"], "layers"))
    return out


def _split_segments(segments, seg_params, prefix: str) -> dict:
    """``repro``'s stacked segment parameters as ``<prefix>.<i>.<leaf>``,
    one layer each."""
    out, layer = {}, 0
    for (period, count), seg in zip(segments, seg_params, strict=True):
        for c in range(count):
            for i in range(len(period)):
                for name, a in _leaves(seg[i]):
                    out[f"{prefix}.{layer}.{name}"] = _tensor(a[c])
                layer += 1
    return out


def opt_state_from_jax(cfg, opt_state: dict) -> dict:
    """``repro``'s optimizer state as the port's (``optim/adamw.py``), split
    per layer as ``params_from_jax`` splits parameters: AdamW's ``{"m":
    tree, "v": tree}`` as ``{"m": {name: tensor}, "v": {...}}``, Adafactor's
    ``{"v": tree of {"vr", "vc"} | {"v"}}`` as ``{"v": {name: {"vr",
    "vc"} | {"v"}}}``."""
    if "m" in opt_state:
        return {k: params_from_jax(cfg, opt_state[k]) for k in ("m", "v")}
    out: dict = {}
    for name, t in params_from_jax(cfg, opt_state["v"]).items():
        leaf, kind = name.rsplit(".", 1)
        out.setdefault(leaf, {})[kind] = t
    return {"v": out}


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_state(state, specs, axes):
    """This rank's blocks of a state (parameters, or an optimizer state's
    nested dicts) of whole tensors, by the matching tree of specs
    (``sharding.rules``); each block is a contiguous copy."""
    from repro_torch.sharding.parallel import shard_leaf

    return _map_specs(lambda t, s: shard_leaf(t, s, axes).contiguous(), state, specs)


def gather_state(state, specs, axes):
    """The whole state from every rank's blocks (collective: every rank of
    the mesh calls it, with the same names in the same order)."""
    from repro_torch.sharding.parallel import gather_leaf

    return _map_specs(lambda t, s: gather_leaf(t.detach(), s, axes), state, specs)


def _global_shape(cfg, name: str, t, d: dict, axes, B: int) -> tuple:
    """The whole shape of a rank's cache block ``t`` (``name`` in the dict
    ``d``) of a global batch of B rows: the KV heads whole, a ``seq_shard``
    cache's positions its ``seq_len``, a recurrent cache's width times
    "model"; ``pos`` is whole on every rank."""
    if name == "pos":
        return tuple(t.shape)
    shape = [B, *t.shape[1:]]
    if name in ("k", "v", "ck", "cv"):
        shape[2] = cfg.n_kv_heads
    if name in ("k", "v", "ck", "cv", "c_kv", "k_pe") and "seq_len" in d:
        shape[1] = d["seq_len"]
    if name == "conv":
        shape[2] *= axes.model_size
    if name == "h":
        shape[1] *= axes.model_size
    return tuple(shape)


def _gather_caches(cfg, caches: list, axes, B: int) -> list:
    """Every rank's cache blocks put together, by the ``rules.cache_specs``
    of the global shapes (``_global_shape``; a cache's ``seq_len`` marks
    the ``seq_shard`` layout); collective."""
    from repro_torch.sharding import parallel as par
    from repro_torch.sharding import rules

    out = []
    for c in caches:
        seq_shard = any("seq_len" in d for d in c.values())
        whole = {key: {n: _global_shape(cfg, n, t, d, axes, B) for n, t in d.items()
                       if isinstance(t, torch.Tensor)} for key, d in c.items()}
        specs = rules.cache_specs([whole], cfg, axes, seq_shard=seq_shard)[0]
        out.append({key: {n: par.gather_leaf(c[key][n].contiguous(), specs[key][n], axes)
                          for n in d} for key, d in whole.items()})
    return out


def caches_to_numpy(cfg, caches: list, axes=None, B: int | None = None) -> list:
    """The port's per-layer caches in ``repro``'s layout: per segment, a
    tuple per period position of dicts whose arrays are stacked over the
    segment's count, ``(count, B, S, KV, dh)`` for GQA's k and v, ``(count,
    B, S, kv_lora_rank)`` and ``(count, B, S, qk_rope_dim)`` for MLA's c_kv
    and k_pe, ``(count, B, M, KV, dh)`` for a cross block's ck and cv under
    ``"cross"``, a ring's ``pos`` ``(count, W)``, the recurrent ``conv`` and
    ``h`` (bfloat16 as uint16 bits). With ``axes`` over a mesh, each
    rank's blocks of the caches of a global batch of ``B`` rows are
    gathered first (collective: every rank calls it)."""
    if axes is not None and axes.mesh is not None:
        caches = _gather_caches(cfg, caches, axes, B)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {key: stack([t[key] for t in trees]) for key in trees[0]
                    if isinstance(trees[0][key], (dict, torch.Tensor))}
        return np.stack([to_numpy(t) for t in trees])

    out, layer = [], 0
    for period, count in cfg.segments:
        n = len(period)
        seg = caches[layer:layer + n * count]
        out.append(tuple(stack(seg[i::n]) for i in range(n)))
        layer += n * count
    return out
