"""Helpers for the parity tests of the port's models against ``repro``
(``test_torch_recurrent.py``, ``test_torch_window.py``,
``test_torch_cross.py``): the same smoke config from both packages,
``repro``'s weights carried into the port's model, ``engine.generate`` on
both sides with every prefill's and serve step's logits recorded, and one
micro-batch's loss and gradients on both sides. ``repro``'s functions run
compiled (``jax.jit``). A model with memory (whisper's encoder frames, the
VLM's vision tokens) gets the same seeded ``memory_inputs`` on both sides;
``nonzero=True`` gives its zero-initialised cross gates, biases and
layernorm biases seeded nonzero values in ``repro``'s tree before the
weights are carried, so that those paths are held too.
"""
from __future__ import annotations

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.configs.registry import smoke_config as jsmoke
from repro.models.model import Model as JModel
from repro.serve import engine as jengine
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_loss_fn as jmake_loss_fn
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models.model import Model
from repro_torch.serve import engine
from repro_torch.train.step import TrainConfig, make_loss_fn

TOL = 1e-5  # float32, of the reference's largest magnitude


def f32(a) -> np.ndarray:
    """An array as float32; the port's bfloat16 arrives as uint16 bits."""
    a = np.asarray(convert.to_numpy(a) if isinstance(a, torch.Tensor) else a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def close(got, want, rel=TOL):
    """got within rel x the largest |want|, compared as float32."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jsmoke(arch), dtype=dtype),
            dataclasses.replace(smoke_config(arch), dtype=dtype))


NONZERO = ("gate", "bq", "bk", "bv", "bi", "bo", "bias")  # zero at init


def nonzero_params(params, seed):
    """``repro``'s parameter tree with every leaf named in NONZERO drawn
    from a seeded normal (scale 0.5; the gates uniform in +-[0.5, 1.5]),
    in the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = getattr(path[-1], "key", None)
        if name not in NONZERO:
            return a
        if name == "gate":
            x = rng.uniform(0.5, 1.5, a.shape) * rng.choice([-1.0, 1.0], a.shape)
        else:
            x = 0.5 * rng.standard_normal(a.shape)
        return jnp.asarray(x, a.dtype)

    return jax.tree_util.tree_map_with_path(draw, params)


def memory_inputs(cfg, B, seed, S_enc=64) -> dict:
    """Seeded numpy memory of ``cfg``'s dtype: ``frames`` (B, S_enc, d) for
    an encoder, ``vision`` (B, n_vision_tokens, d) for a VLM, else none."""
    rng = np.random.default_rng((seed, 5))
    dt = ml_dtypes.bfloat16 if cfg.dtype == "bfloat16" else np.dtype(cfg.dtype)
    out = {}
    if cfg.encoder_segments:
        out["frames"] = rng.standard_normal((B, S_enc, cfg.d_model)).astype(dt)
    if cfg.n_vision_tokens:
        out["vision"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model)).astype(dt)
    return out


def as_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch: dict) -> dict:
    return {k: convert.to_tensor(v, "cpu") for k, v in batch.items()}


def both(arch, dtype="float32", seed=1, nonzero=False, **kw):
    """``repro``'s model and parameters, and the port's model holding them;
    ``kw`` replaces fields of both configs."""
    jc, tc = cfgs(arch, dtype)
    jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    jm = JModel(jc)
    params = jax.jit(jm.init)(jax.random.key(seed))
    if nonzero:
        params = nonzero_params(params, seed)
    tm = Model(tc, device="cpu")
    tm.load_state_dict(convert.params_from_jax(tc, params))
    return jm, params, tm


def recording(make, logs):
    """``make``'s function with each result's logits appended to logs."""
    def wrap(model):
        fn = make(model)

        def call(*args):
            logits, caches = fn(*args)
            logs.append(logits)
            return logits, caches
        return call
    return wrap


def generate_both(arch, S, n_new, seed=1, S_enc=64, **kw):
    """``repro``'s and the port's ``engine.generate`` of the same prompts
    (and memory) with the same weights, each prefill's and serve step's
    logits recorded; ``repro``'s prefill and step compiled. Returns
    (tokens, logits) of ``repro``, then of the port."""
    jm, params, tm = both(arch, seed=seed, **kw)
    toks = np.random.default_rng(seed).integers(0, tm.cfg.vocab, (2, S)).astype(np.int32)
    batch = {"tokens": toks, **memory_inputs(tm.cfg, 2, seed, S_enc)}
    jlogs, tlogs = [], []
    jit = lambda make: lambda m: jax.jit(make(m))  # noqa: E731
    with mock.patch.object(jengine, "make_prefill",
                           recording(jit(jengine.make_prefill), jlogs)), \
            mock.patch.object(jengine, "make_serve_step",
                              recording(jit(jengine.make_serve_step), jlogs)):
        want = np.asarray(jengine.generate(jm, params, as_jax(batch), n_new))
    with mock.patch.object(engine, "make_prefill", recording(engine.make_prefill, tlogs)), \
            mock.patch.object(engine, "make_serve_step",
                              recording(engine.make_serve_step, tlogs)):
        got = engine.generate(tm, as_torch(batch), n_new).numpy()
    return (want, [np.asarray(x) for x in jlogs]), (got, tlogs)


def loss_and_grads_both(arch, S=512, seed=3, S_enc=512, **kw):
    """One micro-batch's loss (``train.step.make_loss_fn``) and its
    gradients: ``jax.value_and_grad`` of ``repro``'s against
    ``torch.autograd.grad`` of the port's, the same weights and batch."""
    jm, params, tm = both(arch, seed=seed, **kw)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, tm.cfg.vocab, (2, S)).astype(np.int32),
             "labels": rng.integers(0, tm.cfg.vocab, (2, S)).astype(np.int32),
             **memory_inputs(tm.cfg, 2, seed, S_enc)}
    batch["labels"][0, :7] = -1
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jmake_loss_fn(jm, JTrainConfig()),
                                                has_aux=True))(params, as_jax(batch))
    names, leaves = zip(*tm.named_parameters())
    with torch.enable_grad():
        tl, tmet = make_loss_fn(tm, TrainConfig())(as_torch(batch))
        grads = torch.autograd.grad(tl, leaves)
    want = convert.params_from_jax(tm.cfg, jax.tree.map(np.asarray, jg))
    return (float(jl), jmet, want), (float(tl), tmet, dict(zip(names, grads)))
