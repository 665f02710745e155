"""Tensor parallelism of the port's other mixers on 4 gloo CPU ranks
against ``repro``'s one-device train step and engine.

``repro``'s own sharded programs do not run on jax 0.9 (ROADMAP.md §3),
and sharding changes no arithmetic where nothing drops, so the oracle is
``repro``'s one-device ``make_train_step``, ``make_prefill``,
``extend_caches``, ``make_serve_step`` and ``generate``, on the float32
smoke configs of deepseek-v3-671b (MLA, a dense and an MoE layer;
capacity factor 8: nothing drops), recurrentgemma-9b (RG-LRU and local
attention over a window of 32), falcon-mamba-7b (Mamba), whisper-base
(the encoder and cross-attention over 16 frames) and llama-3.2-vision-11b
(a gated cross block over 16 vision tokens), with the gates and biases
that are zero at init seeded nonzero (``torch_model_parity.nonzero_params``).
The ranks (tests/torch_tp_mixers_worker.py, started once for the module)
take ``repro``'s weights through ``convert.params_from_jax`` and
``convert.shard_state`` on (data, model) = (1, 4) and (2, 2) (2-D experts),
and:

  * take one AdamW step (grad_accum 2, remat on, the MoE aux loss off as
    in tests/test_torch_sharded_train.py) on 4 x 32 tokens: loss, grad
    norm and every parameter block after the update, gathered;
  * serve 4 prompts of 16 tokens (recurrentgemma also 48: longer than its
    window, so the ring rolls; 16 is shorter, so ``extend_caches``
    re-slots it) with 8 new tokens, with ``seq_shard`` off and on: each
    rank's rows of the prefill and every decode step's logits, the caches
    gathered after prefill, after ``extend_caches`` and after the last
    step, the greedy tokens and ``generate``'s.

Every float is held within 1e-5 x the largest |value| of ``repro``'s
result (a parameter whose AdamW m is at the noise floor, below 1e-6 of
the largest |m|, within lr: Adam's normalized step turns rounding residue
into a move of up to lr).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_mixers_worker as W
from repro.configs.registry import smoke_config as jsmoke
from repro.models.model import Model as JModel
from repro.optim.adamw import OptConfig as JOptConfig
from repro.optim.adamw import init_opt_state as jinit_opt
from repro.serve import engine as jengine
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as jmake_step
from repro_torch import convert
from torch_model_parity import nonzero_params

HERE = pathlib.Path(__file__).resolve().parent
WORLD = 4
TOL = 1e-5  # of the largest |value| of repro's result
TIMEOUT_S = 240  # the ranks' collectives time out at 120 s


def jconfig(name: str):
    """``repro``'s side of ``W.config(name)``."""
    tc = W.config(name)
    af = name.startswith("af-")
    base = jsmoke(W.AF_CONFIGS[name[3:]] if af else W.CONFIGS[name])
    return dataclasses.replace(base, dtype="float32", remat=True, moe_capacity_factor=8.0,
                               segments=tc.segments, n_layers=tc.n_layers)


def train_batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shape = (W.ACCUM, W.B, W.S_TRAIN)
    batch = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    batch["labels"][0, 0, :5] = -1
    key = W.memory_key(cfg)
    if key:
        batch[key] = rng.standard_normal((W.ACCUM, W.B, W.MEMORY, cfg.d_model)).astype(
            np.float32)
    return batch


def init_weights(d: pathlib.Path, name: str, seed: int):
    """``repro``'s weights of ``name`` (gates and biases seeded nonzero),
    also written as the port's ``state_dict`` for the ranks."""
    params = JModel(jconfig(name)).init(jax.random.key(seed))
    params = nonzero_params(params, seed)
    torch.save(convert.params_from_jax(W.config(name), jax.tree.map(np.asarray, params)),
               d / f"init_{name}.pt")
    return params


def start_ranks(d: pathlib.Path, mode: str) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE), os.environ.get("PYTHONPATH", "")]))
    logs = [open(d / f"{mode}{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_tp_mixers_worker.py"), mode,
                               str(r), str(WORLD), str(d / f"store_{mode}"), str(d)], env=env,
                              stdout=f, stderr=subprocess.STDOUT) for r, f in enumerate(logs)]
    return list(zip(procs, logs))


def wait_ranks(d: pathlib.Path, mode: str, started: list, deadline: float) -> list:
    try:
        for p, _ in started:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, f in started:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    bad = [r for r, (p, _) in enumerate(started) if p.returncode != 0]
    assert not bad, "\n".join((d / f"{mode}{r}.log").read_text()[-3000:] for r in bad)
    return [torch.load(d / f"{mode}{r}.pt", weights_only=False) for r in range(WORLD)]


def _train_oracle(name: str, params, batch: dict) -> dict:
    cfg = jconfig(name)
    tcfg = JTrainConfig(opt=JOptConfig(**W.OPT), aux_coef=0.0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p, o, m = jax.jit(jmake_step(JModel(cfg), tcfg))(params, jinit_opt(params, tcfg.opt),
                                                    jnp.int32(W.STEP), jb)
    p, o, m = jax.tree.map(np.asarray, (p, o, m))
    tc = W.config(name)
    return {"metrics": {k: float(v) for k, v in m.items()}, "params": convert.params_from_jax(
        tc, p), "m": convert.params_from_jax(tc, o["m"])}


def _serve_oracle(name: str, params, batch: dict) -> dict:
    """``repro``'s one-device engine: prefill, the extended caches, the
    greedy decode steps' logits, the last caches and ``generate``."""
    jm = JModel(jconfig(name))
    vocab = jm.cfg.vocab
    S = batch["tokens"].shape[1]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, caches = jax.jit(jengine.make_prefill(jm))(params, jb)
    out = {"prefill": np.asarray(logits), "caches_prefill": jax.tree.map(np.asarray, caches)}
    caches = jengine.extend_caches(jm, caches, S, S + W.N_NEW)
    out["caches_extended"] = jax.tree.map(np.asarray, caches)
    step = jax.jit(jengine.make_serve_step(jm))
    tok = jnp.argmax(logits[..., :vocab], -1).astype(jnp.int32)
    toks, steps = [tok], []
    for i in range(W.N_NEW - 1):
        logits, caches = step(params, caches, tok, jnp.int32(S + i))
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits[..., :vocab], -1).astype(jnp.int32)
        toks.append(tok)
    out["steps"] = np.stack(steps)
    out["caches_decoded"] = jax.tree.map(np.asarray, caches)
    out["tokens"] = np.asarray(jnp.concatenate(toks, axis=1))
    out["generate"] = np.asarray(jax.jit(lambda p, b: jengine.generate(jm, p, b, W.N_NEW))(
        params, jb))
    return out


def serve_batch(d: pathlib.Path, prompt: str, cfg) -> dict:
    with np.load(d / f"serve_{prompt}.npz") as z:
        key = W.memory_key(cfg)
        return {k: z[k] for k in z.files if k == "tokens" or k == key}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_mixers")
    rng = np.random.default_rng(61)
    for prompt, S in W.PROMPTS.items():
        np.savez(d / f"serve_{prompt}.npz",
                 tokens=rng.integers(0, 512, (W.B, S)).astype(np.int32),
                 frames=rng.standard_normal((W.B, W.MEMORY, 64)).astype(np.float32),
                 vision=rng.standard_normal((W.B, W.MEMORY, 64)).astype(np.float32))
    params = {}
    for seed, name in enumerate(W.CONFIGS):
        params[name] = init_weights(d, name, seed + 11)
        np.savez(d / f"batch_{name}.npz", **train_batch(W.config(name), seed + 21))
    started = start_ranks(d, "mixers")
    deadline = time.monotonic() + TIMEOUT_S
    want = {}
    try:
        for seed, name in enumerate(W.CONFIGS):
            with np.load(d / f"batch_{name}.npz") as z:
                want[f"train/{name}"] = _train_oracle(name, params[name],
                                                      {k: z[k] for k in z.files})
        for prompt in W.PROMPTS:
            for name in W.CONFIGS:
                if any(c == name and p == prompt for c, _, _, p in W.SERVE_CASES.values()):
                    want[f"serve/{name}/{prompt}"] = _serve_oracle(
                        name, params[name], serve_batch(d, prompt, W.config(name)))
    finally:
        ranks = wait_ranks(d, "mixers", started, deadline)
    return want, ranks


def close(got, want, what: str, scale: float | None = None) -> None:
    """Every float of ``got`` within TOL x the largest |value| of ``want``
    (of the tree where ``scale`` is given); integers equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            close(got[k], want[k], f"{what}/{k}", scale)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, f"{what}/{i}", scale)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=what)
            return
        g, w = g.astype(np.float32), w.astype(np.float32)
        top = float(np.abs(w).max(initial=0.0)) if scale is None else scale
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= TOL * top + 1e-30, (what, err, top)


def _serve(runs, case):
    want, ranks = runs
    name, _, _, prompt = W.SERVE_CASES[case]
    return want[f"serve/{name}/{prompt}"], [got[f"serve/{case}"] for got in ranks]


@pytest.mark.parametrize("case", list(W.TRAIN_CASES))
def test_train_step_matches_repro(runs, case):
    """Loss, grad norm and every parameter after one AdamW step."""
    want, ranks = runs
    w = want[f"train/{W.TRAIN_CASES[case][0]}"]
    lr = w["metrics"]["lr"]
    top = max(float(np.abs(np.asarray(t, np.float32)).max()) for t in w["params"].values())
    floor = 1e-6 * max(float(np.abs(np.asarray(t, np.float32)).max()) for t in w["m"].values())
    for got in ranks:
        g = got[f"train/{case}"]
        for k in ("loss", "grad_norm"):
            assert abs(g["metrics"][k] - w["metrics"][k]) <= TOL * abs(w["metrics"][k]), k
        assert set(g["params"]) == set(w["params"])
        for n, t in w["params"].items():
            a, b = np.asarray(g["params"][n], np.float32), np.asarray(t, np.float32)
            live = np.abs(np.asarray(w["m"][n], np.float32)) >= floor
            assert float(np.abs(a - b)[live].max(initial=0.0)) <= TOL * top, n
            assert float(np.abs(a - b)[~live].max(initial=0.0)) <= lr, n
        assert g["replicas_equal"]


@pytest.mark.parametrize("case", list(W.SERVE_CASES))
def test_prefill_and_decode_steps_match_repro(runs, case):
    """Each rank's rows of the prefill logits and of every greedy step's;
    the tokens equal on every rank."""
    want, ranks = _serve(runs, case)
    for r, got in enumerate(ranks):
        rows = got["rows"]
        close(got["prefill"], want["prefill"][rows], f"rank {r} prefill")
        close(got["steps"], want["steps"][:, rows], f"rank {r} steps")
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("case", list(W.SERVE_CASES))
def test_gathered_caches_match_repro(runs, case):
    """After prefill, after ``extend_caches`` (a ring rolled or re-slotted;
    under ``seq_shard`` the positions move between ranks) and after the
    last decode step: every cache of every layer, gathered."""
    want, ranks = _serve(runs, case)
    for r, got in enumerate(ranks):
        for stage in ("caches_prefill", "caches_extended", "caches_decoded"):
            close(got[stage], want[stage], f"rank {r} {stage}")


@pytest.mark.parametrize("case", list(W.SERVE_CASES))
def test_generate_matches_repro_on_every_rank(runs, case):
    want, ranks = _serve(runs, case)
    for got in ranks:
        np.testing.assert_array_equal(got["generate"], want["generate"])


def test_cache_blocks_follow_cache_specs(runs):
    """A rank's blocks of the caches after the last step, the batch of 4
    over "data" where it is 2: recurrentgemma's ring (layer 2; its one KV
    head replicated, with ``seq_shard`` the ring's slots over "model") and
    RG-LRU's width over "model", Mamba's di, MLA's compressed cache whole
    or over its positions, the cross caches' KV heads (2: over "model" at
    2, replicated at 4) or with ``seq_shard`` their 16 memory positions."""
    _, ranks = runs
    got = {c: ranks[0][f"serve/{c}"]["local"] for c in W.SERVE_CASES}
    assert got["rec/1x4/seq0/s48"][0]["mix.h"] == (4, 16)
    assert got["rec/2x2/seq0/s48"][0]["mix.conv"] == (2, 3, 32)
    assert got["mamba/1x4/seq0/s16"][0]["mix.h"] == (4, 32, 8)
    assert got["mla/1x4/seq0/s16"][0]["mix.c_kv"] == (4, 24, 16)
    assert got["mla/1x4/seq1/s16"][0]["mix.c_kv"] == (4, 6, 16)
    assert got["mla/2x2/seq1/s16"][1]["mix.k_pe"] == (2, 12, 8)
    assert got["whisper/1x4/seq0/s16"][0]["cross.ck"] == (4, 16, 2, 16)
    assert got["whisper/2x2/seq0/s16"][0]["cross.ck"] == (2, 16, 1, 16)
    assert got["whisper/1x4/seq1/s16"][0]["cross.cv"] == (4, 4, 2, 16)
    assert got["vlm/2x2/seq1/s16"][3]["cross.ck"] == (2, 8, 2, 16)
    ring = {c: got[f"rec/{c}"][2] for c in ("1x4/seq0/s48", "1x4/seq1/s48", "2x2/seq1/s16")}
    assert ring == {"1x4/seq0/s48": {"mix.k": (4, 32, 1, 16), "mix.v": (4, 32, 1, 16),
                                     "mix.pos": (32,)},
                    "1x4/seq1/s48": {"mix.k": (4, 8, 1, 16), "mix.v": (4, 8, 1, 16),
                                     "mix.pos": (32,)},
                    "2x2/seq1/s16": {"mix.k": (2, 12, 1, 16), "mix.v": (2, 12, 1, 16),
                                     "mix.pos": (24,)}}
