"""Parameter, optimizer-state, batch and cache specs: ``repro/sharding/rules.py``.

A spec is a tuple with one entry per dimension of a leaf: None (the
dimension is whole on every rank), an axis name, or a tuple of two or
more axis names (their flattened product, the first major); a tuple of
one name is that name, as ``PartitionSpec`` normalizes it. The rules are ``repro``'s
(Megatron's conventions: attention heads, the MLP hidden width and the
vocabulary on "model"; MoE experts on the expert axes; the batch on
("pod", "data"); ``mode="decode"`` puts the MoE's d_expert on "model"),
over the port's ``state_dict`` names.

``repro`` stacks each period position of a segment over the segment's
count, ``(count, ...)``; the port holds one tensor per layer
(``convert.params_from_jax``). Its spec of a layer's leaf is ``repro``'s
spec of the stacked leaf without its leading entry. ``repro`` decides two
things on the stacked shape, and so does the port, from the config's
segment counts (``stacked_shape``): a spec whose rank does not match
the leaf's replicates it, and ZeRO-1 shards the largest replicated
dimension of the stacked state over "data", which may be the stack
dimension: the port's state of that leaf is then not sharded.
"""
from __future__ import annotations

from repro_torch.sharding.spec import Axes

_TABLE = {
    # attention (also cross-attention)
    "wq": (None, None, "m"), "wk": (None, None, "kv"), "wv": (None, None, "kv"),
    "wo": (None, "m", None), "bq": (None, "m"), "bk": (None, "kv"), "bv": (None, "kv"),
    "q_norm": (None, None), "k_norm": (None, None), "gate": (None,),
    # MLA
    "wq_a": (None, None, None), "q_ln": (None, None), "wq_b": (None, None, "m"),
    "wkv_a": (None, None, None), "kv_ln": (None, None), "wk_b": (None, None, "m"),
    "wv_b": (None, None, "m"),
    # MLP
    "wi": (None, None, "m"), "wg": (None, None, "m"), "bi": (None, "m"), "bo": (None, None),
    # RG-LRU
    "wx": (None, None, "m"), "conv": (None, None, "m"), "wa": (None, "m", None, None),
    "lam": (None, "m"),
    # Mamba
    "in_proj": (None, None, "m"), "x_proj": (None, "m", None), "dt_proj": (None, None, "m"),
    "dt_bias": (None, "m"), "A_log": (None, "m", None), "D": (None, "m"),
    "out_proj": (None, "m", None),
    # norms
    "scale": (None, None), "bias": (None, None),
}


def _replicated(n: int) -> tuple:
    return (None,) * n


def _norm(spec) -> tuple:
    """``spec`` with each tuple of one axis name as that name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _block_spec(name: str, parent: str, shape, cfg, axes: Axes, mode: str) -> tuple:
    """``repro``'s spec of a stacked block leaf; ``shape`` is stacked."""
    m = axes.model
    if parent == "moe":
        if name == "router":
            return (None, None, None)
        if mode == "decode":
            if cfg.decode_moe_ep and tuple(axes.expert) == ("data", "model"):
                return {"wi": (None, "data", None, m), "wg": (None, "data", None, m),
                        "wo": (None, "data", m, None)}[name]
            return {"wi": (None, None, None, m), "wg": (None, None, None, m),
                    "wo": (None, None, m, None)}[name]
        return (None, tuple(axes.expert), None, None)
    if parent == "mix" and name == "wi":  # the RG-LRU input gate (block-diagonal)
        if len(shape) == 4:
            return (None, m, None, None)
    if name not in _TABLE:
        return _replicated(len(shape))
    kv = axes.kv_spec(cfg.n_kv_heads)
    spec = tuple({"m": m, "kv": kv}.get(e, None) if isinstance(e, str) else e
                 for e in _TABLE[name])
    return spec if len(spec) == len(shape) else _replicated(len(shape))


def _layer_of(name: str):
    """(segments attribute, layer index) of a per-layer name, or None."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "segments", int(parts[1])
    if parts[0] == "encoder" and parts[1] == "layers":
        return "encoder_segments", int(parts[2])
    return None


def stack_count(cfg, name: str) -> int | None:
    """The count of the segment ``repro`` stacks this layer's leaf over, or
    None for a leaf outside the segments."""
    where = _layer_of(name)
    if where is None:
        return None
    attr, layer = where
    first = 0
    for period, count in getattr(cfg, attr):
        first += len(period) * count
        if layer < first:
            return count
    raise ValueError(f"{name}: layer {layer} is past the config's {first} layers")


def stacked_shape(cfg, name: str, shape) -> tuple:
    """``repro``'s shape of the leaf that holds this one."""
    count = stack_count(cfg, name)
    return tuple(shape) if count is None else (count, *shape)


def _param_spec(name: str, shape, cfg, axes: Axes, mode: str) -> tuple:
    """``repro``'s spec of the (stacked) leaf holding ``name``."""
    parts = name.split(".")
    top = parts[0]
    if top == "embed":
        return (axes.model, None)
    if top == "lm_head":
        return (None, axes.model)
    if top == "pos_embed":
        return (None, None)
    if top == "final_norm" or (len(parts) > 1 and parts[-2] == "final_norm"):
        return (None,)
    if _layer_of(name) is not None:
        return _block_spec(parts[-1], parts[-2], stacked_shape(cfg, name, shape), cfg, axes,
                           mode)
    return _replicated(len(shape))


def _strip(name: str, spec: tuple, cfg) -> tuple:
    return spec[1:] if stack_count(cfg, name) is not None else spec


def param_specs(shapes: dict, cfg, axes: Axes, mode: str = "train") -> dict:
    """{name: spec} for the port's parameters; ``shapes`` maps each
    ``state_dict`` name to its shape (or tensor), unsharded."""
    return {n: _norm(_strip(n, _param_spec(n, tuple(_shape(s)), cfg, axes, mode), cfg))
            for n, s in shapes.items()}


def _shape(s):
    return s.shape if hasattr(s, "shape") else s


def spec_axes(spec) -> tuple:
    """The mesh axes a spec shards over, in the order it names them."""
    return tuple(a for d in spec if d is not None for a in (d if isinstance(d, tuple) else (d,)))


def zero_shard(spec: tuple, shape, axes: Axes) -> tuple:
    """ZeRO-1: shard the largest replicated dimension that "data" divides
    over "data" too (none when the spec already uses "data", as 2-D
    experts do)."""
    if axes.mesh_shape is None or "data" not in axes.mesh_shape:
        return tuple(spec)
    if "data" in spec_axes(spec):
        return tuple(spec)
    dsize = axes.mesh_shape["data"]
    dims = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = -1, 0
    for i, (d, s) in enumerate(zip(dims, shape)):
        if d is None and s % dsize == 0 and s > best_size:
            best, best_size = i, s
    if best >= 0 and best_size >= dsize:
        dims[best] = "data"
    return tuple(dims)


def fit_batch_axes(B: int, axes: Axes) -> tuple | None:
    """Largest prefix of the batch axes whose size product divides B;
    None when not even the first does (small-batch decode shapes
    replicate instead)."""
    out = []
    prod = 1
    for a in axes.batch:
        size = axes.mesh_shape[a] if axes.mesh_shape else 1
        if B % (prod * size) == 0:
            out.append(a)
            prod *= size
        else:
            break
    return tuple(out) if out else None


def _fit(spec: tuple, n: int) -> tuple:
    return tuple((list(spec) + [None] * n)[:n])


def opt_state_specs(state: dict, pspecs: dict, cfg, axes: Axes, zero: bool = True) -> dict:
    """Specs of an optimizer state (``optim/adamw.py``'s layout): AdamW's
    ``m`` and ``v`` mirror their parameter's spec; Adafactor's factored
    ``vr`` drops its last dimension and ``vc`` its second to last, and its
    unfactored ``v`` is replicated, as ``repro``'s walk finds no parameter
    for it. With ``zero``, each is ZeRO-sharded on ``repro``'s stacked
    shape (``zero_shard``), then stripped of the stack entry."""
    full = {n: (None, *spec) if stack_count(cfg, n) is not None else tuple(spec)
            for n, spec in pspecs.items()}  # the stacked specs

    def leaf(name: str, kind: str, shape) -> tuple:
        stacked = stacked_shape(cfg, name, shape)
        base = full[name]
        if kind in ("m", "v_adamw"):
            spec = base
        elif kind == "vr":
            spec = base[:-1]
        elif kind == "vc":
            spec = base[:-2] + base[-1:]
        else:  # Adafactor's unfactored "v"
            spec = ()
        spec = _fit(spec, len(stacked))
        if zero:
            spec = zero_shard(spec, stacked, axes)
        return _norm(_strip(name, spec, cfg))

    if "m" in state:
        return {"m": {n: leaf(n, "m", _shape(t)) for n, t in state["m"].items()},
                "v": {n: leaf(n, "v_adamw", _shape(t)) for n, t in state["v"].items()}}
    return {"v": {n: {k: leaf(n, k, _shape(t)) for k, t in d.items()}
                  for n, d in state["v"].items()}}


def batch_specs(batch: dict, axes: Axes, train: bool = True) -> dict:
    """tokens / labels (accum, B, S) in training, (B, S) otherwise;
    frames / vision carry d_model: the batch dimension over the batch
    axes that divide it."""
    out = {}
    for k, t in batch.items():
        shape = _shape(t)
        bdim = 1 if train else 0
        dims = [None] * len(shape)
        dims[bdim] = fit_batch_axes(shape[bdim], axes)
        out[k] = _norm(dims)
    return out


def cache_specs(caches: list, cfg, axes: Axes, seq_shard: bool = False) -> list:
    """Specs of the port's decode caches (``Model.init_caches``: one dict a
    layer): the batch over the batch axes that divide it; the KV heads
    over "model" when it divides them, or with ``seq_shard`` the sequence
    instead; recurrent widths over "model"."""
    kv_ax = None if seq_shard else axes.kv_spec(cfg.n_kv_heads)
    m = axes.model
    s_ax = m if seq_shard else None

    def walk(name: str, shape) -> tuple:
        nd = len(shape)
        b = fit_batch_axes(shape[0], axes) if nd >= 1 else None
        if name in ("k", "v", "ck", "cv"):  # (B, S, KV, dh)
            sx = s_ax if shape[1] % axes.model_size == 0 else None
            return (b, sx, kv_ax if sx is None else None, None)
        if name in ("c_kv", "k_pe"):  # (B, S, r)
            sx = s_ax if shape[1] % axes.model_size == 0 else None
            return (b, sx, None)
        if name == "pos":  # (W,)
            return (None,)
        if name == "conv":  # (B, K, width)
            return (b, None, m)
        if name == "h":  # RG-LRU (B, w), Mamba (B, di, N)
            return (b, m) + (None,) * (nd - 2)
        return _replicated(nd)

    def tree(c):
        return {k: tree(v) if isinstance(v, dict) else _norm(walk(k, _shape(v)))
                for k, v in c.items()}

    return [tree(c) for c in caches]
