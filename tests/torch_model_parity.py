"""Helpers for the parity tests of the port's models against ``repro``
(``test_torch_recurrent.py``, ``test_torch_window.py``): the same smoke
config from both packages, ``repro``'s weights carried into the port's
model, ``engine.generate`` on both sides with every prefill's and serve
step's logits recorded, and one micro-batch's loss and gradients on both
sides. ``repro``'s functions run compiled (``jax.jit``).
"""
from __future__ import annotations

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
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


def both(arch, dtype="float32", seed=1):
    """``repro``'s model and parameters, and the port's model holding them."""
    jc, tc = cfgs(arch, dtype)
    jm = JModel(jc)
    params = jax.jit(jm.init)(jax.random.key(seed))
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


def generate_both(arch, S, n_new, seed=1):
    """``repro``'s and the port's ``engine.generate`` of the same prompts
    with the same weights, each prefill's and serve step's logits recorded;
    ``repro``'s prefill and step compiled. Returns (tokens, logits) of
    ``repro``, then of the port."""
    jm, params, tm = both(arch, seed=seed)
    toks = np.random.default_rng(seed).integers(0, tm.cfg.vocab, (2, S)).astype(np.int32)
    jlogs, tlogs = [], []
    jit = lambda make: lambda m: jax.jit(make(m))  # noqa: E731
    with mock.patch.object(jengine, "make_prefill",
                           recording(jit(jengine.make_prefill), jlogs)), \
            mock.patch.object(jengine, "make_serve_step",
                              recording(jit(jengine.make_serve_step), jlogs)):
        want = np.asarray(jengine.generate(jm, params, {"tokens": jnp.asarray(toks)}, n_new))
    with mock.patch.object(engine, "make_prefill", recording(engine.make_prefill, tlogs)), \
            mock.patch.object(engine, "make_serve_step",
                              recording(engine.make_serve_step, tlogs)):
        got = engine.generate(tm, {"tokens": torch.from_numpy(toks)}, n_new).numpy()
    return (want, [np.asarray(x) for x in jlogs]), (got, tlogs)


def loss_and_grads_both(arch, S=512, seed=3):
    """One micro-batch's loss (``train.step.make_loss_fn``) and its
    gradients: ``jax.value_and_grad`` of ``repro``'s against
    ``torch.autograd.grad`` of the port's, the same weights and batch."""
    jm, params, tm = both(arch, seed=seed)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, tm.cfg.vocab, (2, S)).astype(np.int32),
             "labels": rng.integers(0, tm.cfg.vocab, (2, S)).astype(np.int32)}
    batch["labels"][0, :7] = -1
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jmake_loss_fn(jm, JTrainConfig()),
                                                has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    names, leaves = zip(*tm.named_parameters())
    with torch.enable_grad():
        tl, tmet = make_loss_fn(tm, TrainConfig())({k: torch.from_numpy(v)
                                                    for k, v in batch.items()})
        grads = torch.autograd.grad(tl, leaves)
    want = convert.params_from_jax(tm.cfg, jax.tree.map(np.asarray, jg))
    return (float(jl), jmet, want), (float(tl), tmet, dict(zip(names, grads)))
