"""The port's continuous batcher against ``repro``'s on the CPU.

``tests/test_batching.py`` ported: the same smoke configs and seeded
prompts, ``repro``'s weights carried into the port by
``convert.params_from_jax``, float32. Per request the port's batcher must
give ``repro``'s batcher's tokens and the port's own ``generate``'s; the
per-slot decode under it is held to ``repro``'s ``gqa_forward`` within
1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.serve.batching import ContinuousBatcher as JBatcher
from repro.serve.batching import Request as JRequest
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models import attention
from repro_torch.models.model import Model
from repro_torch.serve import engine
from repro_torch.serve.batching import ContinuousBatcher, Request, _splice


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def both(arch, seed=0):
    """``repro``'s model and parameters, and the port's model with them."""
    jc = dataclasses.replace(jsmoke(arch), dtype="float32")
    tc = dataclasses.replace(smoke_config(arch), dtype="float32")
    jm = JModel(jc)
    params = jm.init(jax.random.key(seed))
    tm = Model(tc, device="cpu")
    tm.load_state_dict(convert.params_from_jax(tc, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def dense():
    return both("qwen3-4b")


def prompts_of(cfg, rng, lengths):
    return [rng.integers(0, cfg.vocab, L).astype(np.int32) for L in lengths]


def generated(tm, prompt, n_new) -> list:
    return engine.generate(tm, {"tokens": torch.from_numpy(prompt[None])}, n_new)[0].tolist()


def test_batched_equals_individual_and_repro(dense):
    """2 slots over 3 requests (one re-admission): the port's batcher gives
    each request's tokens alone (``generate``) and ``repro``'s batcher's."""
    jm, params, tm = dense
    prompts = prompts_of(tm.cfg, np.random.default_rng(0), (5, 9, 7))
    n_new = 6
    got = ContinuousBatcher(tm, n_slots=2, s_max=32).run(
        [Request(i, p, n_new) for i, p in enumerate(prompts)])
    want = JBatcher(jm, params, n_slots=2, s_max=32).run(
        [JRequest(i, p, n_new) for i, p in enumerate(prompts)])
    assert set(got) == set(want) == {0, 1, 2}
    for i, p in enumerate(prompts):
        assert got[i] == want[i] == generated(tm, p, n_new), i


def test_slots_reused(dense):
    jm, params, tm = dense
    rng = np.random.default_rng(1)
    reqs = [(i, rng.integers(0, tm.cfg.vocab, 4).astype(np.int32), 3) for i in range(5)]
    b = ContinuousBatcher(tm, n_slots=2, s_max=16)
    out = b.run([Request(*r) for r in reqs])
    assert len(out) == 5 and all(len(v) == 3 for v in out.values())
    assert out == JBatcher(jm, params, n_slots=2, s_max=16).run([JRequest(*r) for r in reqs])
    assert (b.positions == -1).all() and not b.out_tokens


def test_sequence_ends_at_s_max(dense):
    """A budget past the slot's room ends at position s_max - 1, as
    ``repro``'s does."""
    jm, params, tm = dense
    p = np.random.default_rng(2).integers(0, tm.cfg.vocab, 10).astype(np.int32)
    got = ContinuousBatcher(tm, n_slots=2, s_max=14).run([Request(0, p, 20)])
    want = JBatcher(jm, params, n_slots=2, s_max=14).run([JRequest(0, p, 20)])
    assert got == want and len(got[0]) == 4


def test_rejects_unsupported_arch():
    """recurrentgemma-9b (sliding window) and falcon-mamba-7b (recurrent
    mixers): the port's models build, and its batcher raises the
    AssertionError ``repro``'s raises (``serve.engine`` serves them)."""
    jc = jsmoke("recurrentgemma-9b")
    jm = JModel(jc)
    with pytest.raises(AssertionError):
        JBatcher(jm, jm.init(jax.random.key(0)), 2, 16)
    with pytest.raises(AssertionError, match="rope/non-windowed"):
        ContinuousBatcher(Model(smoke_config("recurrentgemma-9b"), device="cpu"), 2, 16)
    with pytest.raises(AssertionError, match="recurrent mixers"):
        ContinuousBatcher(Model(smoke_config("falcon-mamba-7b"), device="cpu"), 2, 16)


def test_moe_smoke_config_equals_repro():
    """deepseek-moe-16b: prefill through the sorted dispatch, decode token
    by token with slots at different positions."""
    jm, params, tm = both("deepseek-moe-16b", seed=3)
    prompts = prompts_of(tm.cfg, np.random.default_rng(3), (6, 11, 4))
    n_new = 5
    got = ContinuousBatcher(tm, n_slots=2, s_max=24).run(
        [Request(i, p, n_new) for i, p in enumerate(prompts)])
    want = JBatcher(jm, params, n_slots=2, s_max=24).run(
        [JRequest(i, p, n_new) for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        assert got[i] == want[i] == generated(tm, p, n_new), i


def test_gqa_per_slot_decode_matches_repro():
    """Three slots decoding at positions 4, -3 (counted from the end, as
    jax indexes) and 16 (past the cache: dropped), against ``repro``'s
    per-slot path: outputs and caches within 1e-5."""
    jc = dataclasses.replace(jsmoke("qwen3-4b"), dtype="float32")
    tc = dataclasses.replace(smoke_config("qwen3-4b"), dtype="float32")
    jp = jattn.init_attention(jax.random.key(5), jc, None)
    p = attention.Attention(tc, None, "meta").to_empty(device="cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    rng = np.random.default_rng(4)
    B, S_max = 3, 16
    x = rng.standard_normal((B, 1, tc.d_model)).astype(np.float32)
    shape = (B, S_max, tc.n_kv_heads, tc.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    pos = np.array([4, -3, 16], np.int32)
    jout, jcache = jattn.gqa_forward(jnp.asarray(x), jp, jc, None,
                                     cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                                     decode=True, positions=jnp.asarray(pos))
    out, cache = attention.gqa_forward(
        torch.from_numpy(x), p, tc, decode=True, positions=torch.from_numpy(pos),
        cache={"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())})
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    for name, old in (("k", ck), ("v", cv)):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(cache[name][2].numpy(), old[2])  # dropped


def test_splice_pads_the_rest_of_the_row():
    full = [{"mix": {"k": torch.ones(2, 6, 1, 2), "v": torch.ones(2, 6, 1, 2)}}]
    part = [{"mix": {"k": torch.full((1, 4, 1, 2), 5.0), "v": torch.full((1, 4, 1, 2), 7.0)}}]
    _splice(full, part, 1)
    k = full[0]["mix"]["k"]
    assert (k[0] == 1).all() and (k[1, :4] == 5).all() and (k[1, 4:] == 0).all()
    with pytest.raises(ValueError, match="does not fit"):
        _splice(full, [{"mix": {"k": torch.ones(1, 7, 1, 2), "v": torch.ones(1, 7, 1, 2)}}], 0)
