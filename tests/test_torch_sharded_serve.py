"""Sharded prefill and decode of the port on 4 gloo CPU ranks against
``repro``'s one-device engine.

``repro``'s own sharded serving does not run on jax 0.9 (its sharded
paths raise ShardingTypeError: ROADMAP.md §3), and sharding changes no
arithmetic where nothing drops, so the oracle is ``repro``'s one-device
``make_prefill``, ``extend_caches``, ``make_serve_step`` and ``generate``
on the qwen3-4b and deepseek-moe-16b smoke configs (float32, capacity
factor 8: nothing drops), with 4 prompts of 16 tokens and 8 new tokens
(7 in two cases, whose 23 positions divide over no model axis). The ranks
(tests/torch_sharded_serve_worker.py, started once for the module) take
``repro``'s weights through ``convert.params_from_jax`` and
``convert.shard_state`` (the train layout; decode re-lays the experts)
and serve the same prompts on (data, model) = (1, 4), (2, 2) with
experts over ("data", "model"), and (pod, data, model) = (2, 1, 2), each
with ``decode_moe_ep`` off and on and ``seq_shard`` off and on, and the
qwen3-4b config with 6 heads on model = 4 (``Axes.pad_heads`` pads them
to 8; ``repro``'s side runs its padded weights, as
tests/test_torch_sharded_train.py does). Each rank's rows of the prefill
and decode logits, the caches gathered after prefill, after
``extend_caches`` and after the last step, within rtol = atol = 2e-5;
the greedy tokens and ``generate``'s equal; replicas the same bits.

Where EP x TP decode drops assignments (its expert capacity at a few
tokens a rank is 1 or 2 whatever the factor), the one-device engine is
not the oracle: ``moe_forward(..., tp_axis="model")`` is held to
``repro``'s on a virtual (2, 2) CPU mesh (tests/torch_mesh_reference.py
``moe_tp``), at capacity factors 8, 1.25 and 0.5.
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

import torch_mesh_cases as C
import torch_sharded_serve_worker as W
from repro.configs.registry import smoke_config as jsmoke
from repro.models.model import Model as JModel
from repro.serve import engine as jengine
from repro.sharding.spec import Axes as JAxes
from repro_torch import convert

HERE = pathlib.Path(__file__).resolve().parent
WORLD = 4
B, S = 4, 16
TOL = 2e-5
TIMEOUT_S = 240  # the ranks' collectives time out at 120 s
CASES = list(W.CASES)


def _jcfg(name: str):
    arch, kw = W.CONFIGS[name]
    return dataclasses.replace(jsmoke(arch), dtype="float32", moe_capacity_factor=8.0, **kw)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _oracle(name: str, n_new: int, params, tokens: np.ndarray) -> dict:
    """``repro``'s one-device engine: prefill, the extended caches, the
    greedy decode steps' logits, the last caches and ``generate``."""
    jm = JModel(_jcfg(name))
    vocab = jm.cfg.vocab
    batch = {"tokens": jnp.asarray(tokens)}
    logits, caches = jax.jit(jengine.make_prefill(jm))(params, batch)
    out = {"prefill": np.asarray(logits), "caches_prefill": _tree_np(caches)}
    caches = jengine.extend_caches(jm, caches, S, S + n_new)
    out["caches_extended"] = _tree_np(caches)
    step = jax.jit(jengine.make_serve_step(jm))
    tok = jnp.argmax(logits[..., :vocab], -1).astype(jnp.int32)
    toks, steps = [tok], []
    for i in range(n_new - 1):
        logits, caches = step(params, caches, tok, jnp.int32(S + i))
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits[..., :vocab], -1).astype(jnp.int32)
        toks.append(tok)
    out["steps"] = np.stack(steps)
    out["caches_decoded"] = _tree_np(caches)
    out["tokens"] = np.asarray(jnp.concatenate(toks, axis=1))
    gen = jax.jit(lambda p, b: jengine.generate(jm, p, b, n_new))
    out["generate"] = np.asarray(gen(params, batch))
    return out


def _start(cmd, env, log):
    f = open(log, "w")
    return subprocess.Popen([sys.executable, *map(str, cmd)], env=env, stdout=f,
                            stderr=subprocess.STDOUT), f


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_serve")
    tokens = np.random.default_rng(53).integers(0, 512, (B, S)).astype(np.int32)
    np.savez(d / "tokens.npz", tokens=tokens)
    params = {}
    for name in W.CONFIGS:
        cfg = _jcfg(name)
        axes = JAxes(mesh_shape={"data": 1, "model": 4}) if name == "padded" else None
        params[name] = JModel(cfg, axes).init(jax.random.key(7))  # heads padded with axes
        torch.save(convert.params_from_jax(W.config(name),
                                           jax.tree.map(np.asarray, params[name])),
                   d / f"init_{name}.pt")
    path = os.pathsep.join([str(HERE.parent / "src"), str(HERE),
                            os.environ.get("PYTHONPATH", "")])
    ref_env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    port_env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    procs = [_start([HERE / "torch_mesh_reference.py", d / "ref.npz", "moe_tp"], ref_env,
                    d / "ref.log")]
    procs += [_start([HERE / "torch_sharded_serve_worker.py", r, WORLD, d / "store", d],
                     port_env, d / f"rank{r}.log") for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        want = {key: _oracle(*key, params[key[0]], tokens)
                for key in sorted({W.oracle_key(c) for c in CASES})}
        for p, _ in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    logs = ["ref.log", *(f"rank{r}.log" for r in range(WORLD))]
    bad = [log for (p, _), log in zip(procs, logs) if p.returncode != 0]
    assert not bad, "\n".join(f"{log}: {(d / log).read_text()[-3000:]}" for log in bad)
    with np.load(d / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    return want, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], ref


def _close(got, want, what: str) -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}/{i}")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                                   rtol=TOL, atol=TOL, err_msg=what)


def _want(runs, case):
    want, ranks, _ = runs
    return want[W.oracle_key(case)], ranks


@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_repro(runs, case):
    want, ranks = _want(runs, case)
    for r, got in enumerate(ranks):
        rows = got[case]["rows"]
        _close(got[case]["prefill"], want["prefill"][rows], f"rank {r} prefill")


@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_repro(runs, case):
    """Each greedy step's logits, the rank's rows; the tokens equal."""
    want, ranks = _want(runs, case)
    for r, got in enumerate(ranks):
        rows = got[case]["rows"]
        _close(got[case]["steps"], want["steps"][:, rows], f"rank {r} steps")
        np.testing.assert_array_equal(got[case]["tokens"], want["tokens"])


@pytest.mark.parametrize("case", CASES)
def test_gathered_caches_match_repro(runs, case):
    """After prefill, after ``extend_caches`` (under ``seq_shard`` the
    positions move between ranks) and after the last decode step."""
    want, ranks = _want(runs, case)
    for r, got in enumerate(ranks):
        for stage in ("caches_prefill", "caches_extended", "caches_decoded"):
            _close(got[case][stage], want[stage], f"rank {r} {stage}")


@pytest.mark.parametrize("case", CASES)
def test_generate_matches_repro_on_every_rank(runs, case):
    want, ranks = _want(runs, case)
    for got in ranks:
        np.testing.assert_array_equal(got[case]["generate"], want["generate"])
        assert got[case]["generate"].shape == (B, W.CASES[case][4])


@pytest.mark.parametrize("case", CASES)
def test_replicas_and_the_decode_layout(runs, case):
    """The ranks that hold the same rows hold the same bits of every logit;
    after decoding, every parameter block is ``convert.shard_state`` of
    the whole weights by ``rules.param_specs(mode="decode")``."""
    _, ranks = _want(runs, case)
    for got in ranks:
        assert got[case]["replicas_equal"]
        assert got[case]["layout"] == "decode" and got[case]["decode_layout"]


def test_cache_blocks_follow_cache_specs(runs):
    """A rank's block of the first layer's k after the last step: the batch
    over the batch axes that divide 4, the KV heads over "model" where it
    divides them (qwen3-4b smoke: 2 KV heads, replicated on 4), with
    ``seq_shard`` the sequence (24 over 4 or 2; 23 whole) and every head."""
    _, ranks, _ = runs
    got = {c: ranks[0][c]["local_cache"] for c in CASES}
    assert got["qwen3/1x4/ep0/seq0"] == (4, 24, 2, 16)
    assert got["qwen3/2x2/ep0/seq0"] == (2, 24, 1, 16)
    assert got["qwen3/2x1x2/ep0/seq0"] == (2, 24, 1, 16)
    assert got["qwen3/1x4/ep0/seq1"] == (4, 6, 2, 16)
    assert got["moe/2x2/ep1/seq1"] == (2, 12, 2, 16)
    assert got["qwen3/1x4/ep0/seq1/n7"] == (4, 23, 2, 16)


@pytest.mark.parametrize("name", list(C.MOE_TP_CASES))
def test_ep_tp_dispatch_matches_repro_mesh(runs, name):
    """EP x TP at S = 1 on (2, 2): each rank's rows of the output and the
    aux loss against ``repro``'s ``moe_forward(..., tp_axis="model")``;
    both sort paths of the port give the same bits. Below capacity 8
    assignments drop (counted by ``recording_drops``)."""
    _, ranks, ref = runs
    dropped = 0
    for got in ranks:
        res = got["moe_tp"][name]
        want = ref[f"{name}/out"][got["moe_tp"]["rows"]]
        np.testing.assert_allclose(res["out"], want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res["aux"], ref[f"{name}/aux"], rtol=TOL, atol=TOL)
        assert res["same_plain"]
        dropped += sum(c + e for _, c, e in res["drops"])
    assert (dropped == 0) == (C.MOE_TP_CASES[name] >= 8)


def test_a_sharded_model_has_no_batcher(runs):
    _, ranks, _ = runs
    for got in ranks:
        assert got["batcher"] is not None and "repro's batcher has no mesh" in got["batcher"]


def test_serving_imports_neither_jax_nor_repro():
    code = ("import sys; import repro_torch.serve.engine, repro_torch.sharding.parallel, "
            "repro_torch.models.model; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
