"""The port's sharding rules (``repro_torch/sharding/rules.py``) against
``repro``'s, leaf by leaf, for all eleven configs at their published
widths, on abstract shapes only (``jax.eval_shape`` on ``repro``'s side,
the meta device on the port's): no weight is drawn.

``repro`` stacks each period position of a segment over its count; the
port's spec of a layer's leaf is ``repro``'s spec of the stacked leaf
without its leading entry (``flat_specs`` walks ``repro``'s tree as
``convert.params_from_jax`` walks its parameters). Meshes (1, 4), (2, 2),
(2, 4), (16, 16) and (2, 16, 16), experts over "model" and over ("data",
"model") (the latter for the MoE configs). Covered: ``param_specs``
(train and decode), ``opt_state_specs`` with ZeRO-1 for AdamW and
Adafactor, ``batch_specs``, ``cache_specs`` (heads and sequence
sharding), ``Axes.pad_heads`` / ``kv_spec``, and the padded parameter
shapes of ``Model(cfg, axes=..., device="meta")``
against ``repro.models.model.abstract_params(cfg, axes=axes)``."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_config as jget_config
from repro.models.model import Model as JModel
from repro.models.model import abstract_params
from repro.optim import adamw as jadamw
from repro.sharding import rules as jrules
from repro.sharding.spec import Axes as JAxes
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.sharding.spec import Axes

MESHES = {(1, 4): ("data", "model"), (2, 2): ("data", "model"), (2, 4): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
CASES = [(shape, e2d) for shape in MESHES for e2d in (False, True)]
# experts over ("data", "model") change only the MoE configs' specs
ARCH_CASES = [(arch, shape, e2d) for arch in ARCH_IDS for shape, e2d in CASES
              if not e2d or get_config(arch).n_experts]


def both_axes(shape, expert_2d):
    names = MESHES[shape]
    kw = dict(batch=tuple(a for a in ("pod", "data") if a in names),
              expert=("data", "model") if expert_2d else ("model",),
              mesh_shape=dict(zip(names, shape)))
    return Axes(**kw), JAxes(**kw)


def as_spec(s):
    return tuple(s) if isinstance(s, P) else s


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _segments(segments, seg_tree, prefix):
    layer = 0
    for (period, count), seg in zip(segments, seg_tree, strict=True):
        for _ in range(count):
            for i in range(len(period)):
                for name, leaf in _leaves(seg[i]):
                    yield f"{prefix}.{layer}.{name}", leaf, True
                layer += 1


def flat_specs(cfg, tree) -> dict:
    """{port name: (repro's leaf, stacked)} over a tree shaped as
    ``repro``'s parameters (specs or shapes)."""
    out = {}
    for key, sub in tree.items():
        if key == "segments":
            out.update((n, (l, s)) for n, l, s in _segments(cfg.segments, sub, "layers"))
        elif key == "encoder":
            out.update((n, (l, s)) for n, l, s in _segments(cfg.encoder_segments,
                                                              sub["segments"], "encoder.layers"))
            out.update((n, (l, False)) for n, l in _leaves(sub["final_norm"],
                                                           "encoder.final_norm"))
        else:
            out.update((n, (l, False)) for n, l in _leaves(sub, key))
    return out


def strip(spec, stacked):
    spec = as_spec(spec)
    return spec[1:] if stacked else spec


@functools.lru_cache(maxsize=None)
def repro_params(arch, shape, e2d):
    _, jaxes = both_axes(shape, e2d)
    return abstract_params(jget_config(arch), axes=jaxes)


@functools.lru_cache(maxsize=None)
def port_shapes(arch, shape, e2d):
    axes, _ = both_axes(shape, e2d)
    m = Model(get_config(arch), axes=axes, device="meta")
    return {n: tuple(p.shape) for n, p in m.named_parameters()}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(MESHES))
def test_padded_shapes_match_abstract_params(arch, shape):
    """Heads and vocabulary padded to the model axis, as ``repro``'s
    ``Model(cfg, axes)`` pads them."""
    cfg = get_config(arch)
    want = {n: tuple(l.shape[1:] if s else l.shape)
            for n, (l, s) in flat_specs(cfg, repro_params(arch, shape, False)).items()}
    assert port_shapes(arch, shape, False) == want


@pytest.mark.parametrize("arch,shape,e2d", ARCH_CASES)
def test_param_specs_match_repro(arch, shape, e2d):
    cfg = get_config(arch)
    axes, jaxes = both_axes(shape, e2d)
    shapes = port_shapes(arch, shape, e2d)
    abstract = repro_params(arch, shape, e2d)
    for mode in ("train", "decode"):
        want = {n: strip(s, st) for n, (s, st) in flat_specs(
            cfg, jrules.param_specs(abstract, jget_config(arch), jaxes, mode=mode)).items()}
        assert rules.param_specs(shapes, cfg, axes, mode=mode) == want, mode


@pytest.mark.parametrize("arch,shape,e2d", ARCH_CASES)
def test_opt_state_specs_match_repro(arch, shape, e2d):
    """ZeRO-1 over "data" decided on the stacked shapes: AdamW's m and v,
    Adafactor's factored vr / vc and unfactored v."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    axes, jaxes = both_axes(shape, e2d)
    shapes = port_shapes(arch, shape, e2d)
    pspecs = rules.param_specs(shapes, cfg, axes)
    abstract = repro_params(arch, shape, e2d)
    jpspecs = jrules.param_specs(abstract, jcfg, jaxes)
    params = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    groups = adamw.segment_groups(cfg, params)
    for name in ("adamw", "adafactor"):
        ocfg = adamw.OptConfig(name=name)
        jstate = jax.eval_shape(lambda p: jadamw.init_opt_state(p, jadamw.OptConfig(name=name)),
                                abstract)
        jspecs = jrules.opt_state_specs(jstate, jpspecs, jcfg, jaxes, zero=True)
        state = adamw.init_opt_state(params, ocfg, groups)
        got = rules.opt_state_specs(state, pspecs, cfg, axes, zero=True)
        if name == "adamw":
            for kind in ("m", "v"):
                want = {n: strip(s, st) for n, (s, st) in flat_specs(cfg, jspecs[kind]).items()}
                assert got[kind] == want, kind
        else:
            want: dict = {}
            for n, (s, st) in flat_specs(cfg, jspecs["v"]).items():
                leaf, kind = n.rsplit(".", 1)
                want.setdefault(leaf, {})[kind] = strip(s, st)
            assert got["v"] == want


@pytest.mark.parametrize("shape,e2d", CASES)
@pytest.mark.parametrize("B", [1, 2, 8, 32, 64])
def test_batch_specs_match_repro(shape, e2d, B):
    axes, jaxes = both_axes(shape, e2d)
    cfg = get_config("whisper-base")
    for train in (True, False):
        lead = (2,) if train else ()
        batch = {"tokens": lead + (B, 16), "labels": lead + (B, 16),
                 "frames": lead + (B, 16, cfg.d_model)}
        jbatch = {k: jax.ShapeDtypeStruct(v, np.int32) for k, v in batch.items()}
        want = {k: as_spec(v) for k, v in jrules.batch_specs(jbatch, jaxes, train=train).items()}
        assert rules.batch_specs(batch, axes, train=train) == want


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (16, 16), (2, 16, 16)])
def test_cache_specs_match_repro(arch, shape):
    """Per layer and cache leaf: k / v (and the cross ck / cv) over the KV
    heads or, with seq_shard, the sequence; MLA's compressed cache;
    the recurrent states; the ring's positions."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    axes, jaxes = both_axes(shape, False)
    B, S, M = 32, 64, 16 if (cfg.encoder_segments or cfg.n_vision_tokens) else 0
    caches = Model(cfg, device="meta").init_caches(B, S, memory_len=M, device="meta")
    jcaches = jax.eval_shape(lambda: JModel(jcfg).init_caches(B, S, memory_len=M))
    for seq_shard in (False, True):
        got = rules.cache_specs(caches, cfg, axes, seq_shard=seq_shard)
        jspecs = jrules.cache_specs(jcaches, jcfg, jaxes, seq_shard=seq_shard)
        layer = 0
        for (period, count), seg in zip(jcfg.segments, jspecs, strict=True):
            for c in range(count):
                for i in range(len(period)):
                    want = jax.tree.map(lambda s: as_spec(s)[1:], seg[i],
                                        is_leaf=lambda s: isinstance(s, P))
                    assert got[layer] == want, (layer, seq_shard)
                    layer += 1
        assert layer == len(got)


@pytest.mark.parametrize("shape", list(MESHES))
def test_head_helpers_match_repro(shape):
    axes, jaxes = both_axes(shape, False)
    for h in range(1, 130):
        assert axes.pad_heads(h) == jaxes.pad_heads(h)
        assert axes.kv_spec(h) == jaxes.kv_spec(h)
    assert axes.batch_size == int(np.prod([axes.mesh_shape[a] for a in axes.batch]))
