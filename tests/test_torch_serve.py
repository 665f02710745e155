"""The port's serving engine on the CPU: decode against the full forward,
prefill / extend / step / generate against ``repro`` on the same weights,
the flash prefill at S = 8192, and sampling."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke
from repro.models.model import Model as JModel
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.kernels import flash
from repro_torch.models.model import Model
from repro_torch.serve import engine
from torch_parity import BF16_TIE, router_margins


@pytest.fixture(autouse=True)
def _no_grad():
    """Parameters require grad (the port trains): every case here compares
    forward passes, so it runs under ``torch.no_grad()``, as serving does."""
    with torch.no_grad():
        yield


RNG = np.random.default_rng(3)
DENSE = ["qwen3-4b", "qwen2.5-32b", "starcoder2-7b"]


def both(arch, dtype="float32", seed=1, **kw):
    jc = dataclasses.replace(jsmoke(arch), dtype=dtype, **kw)
    tc = dataclasses.replace(smoke_config(arch), dtype=dtype, **kw)
    jm = JModel(jc)
    params = jm.init(jax.random.key(seed))
    tm = Model(tc, device="cpu")
    tm.load_state_dict(convert.params_from_jax(tc, params))
    return jm, params, tm


def f32(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.uint16:  # the port's bfloat16, as bits
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def close(got, want, rel):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= rel * scale, (np.abs(got - want).max(), scale)


def tokens(cfg, B, T):
    return RNG.integers(0, cfg.vocab, (B, T)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_equals_forward(arch):
    """Three decode steps after a prefill against the teacher-forced
    forward (``tests/test_serve.py``'s check, on the port alone)."""
    tm = Model(smoke_config(arch), device="cpu", seed=2)
    T = 20
    toks = torch.from_numpy(tokens(tm.cfg, 2, T))
    full, _, _ = tm({"tokens": toks})
    _, caches = engine.make_prefill(tm)({"tokens": toks[:, : T - 3]})
    caches = engine.extend_caches(tm, caches, T - 3, T)
    step = engine.make_serve_step(tm)
    for i in range(3):
        pos = T - 3 + i
        lg, caches = step(caches, toks[:, pos:pos + 1], pos)
        close(lg[:, 0].float().numpy(), full[:, pos].float().numpy(), 0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_extend_and_step_match_repro(dtype):
    jm, params, tm = both("qwen3-4b", dtype)
    T = 17
    toks = tokens(jm.cfg, 2, T)
    jlg, jcaches = jengine.make_prefill(jm)(params, {"tokens": jnp.asarray(toks[:, :-1])})
    lg, caches = engine.make_prefill(tm)({"tokens": torch.from_numpy(toks[:, :-1])})
    tol = 1e-4 if dtype == "float32" else 5e-2
    close(convert.to_numpy(lg), jlg, tol)

    def same_caches(port, ref):
        got = convert.caches_to_numpy(tm.cfg, port)
        assert len(got) == len(ref)
        for g_seg, r_seg in zip(got, ref):
            for g, r in zip(g_seg, r_seg):
                for name in ("k", "v"):
                    close(g["mix"][name], r["mix"][name], tol)

    same_caches(caches, jcaches)
    jcaches = jengine.extend_caches(jm, jcaches, T - 1, T + 4)
    caches = engine.extend_caches(tm, caches, T - 1, T + 4)
    assert caches[0]["mix"]["k"].shape == (2, T + 4, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    same_caches(caches, jcaches)
    jlg, jcaches = jengine.make_serve_step(jm)(params, jcaches, jnp.asarray(toks[:, -1:]),
                                               jnp.int32(T - 1))
    lg, caches = engine.make_serve_step(tm)(caches, torch.from_numpy(toks[:, -1:]), T - 1)
    close(convert.to_numpy(lg), jlg, tol)
    same_caches(caches, jcaches)


def test_generate_matches_repro_tokens():
    jm, params, tm = both("qwen3-4b", seed=0)
    toks = tokens(jm.cfg, 4, 8)
    want = jengine.generate(jm, params, {"tokens": jnp.asarray(toks)}, 6)
    got = engine.generate(tm, {"tokens": torch.from_numpy(toks)}, 6)
    assert got.dtype == torch.int32 and got.shape == (4, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) < tm.cfg.vocab


def test_flash_prefill_at_8192_matches_repro(monkeypatch):
    """S = 8192 with flash_attention=True: the port's prefill runs the flash
    kernel's twin (on the CPU), ``repro``'s its pure-JAX pair schedule."""
    jm, params, tm = both("qwen3-4b", flash_attention=True)
    twin_calls = []
    twin = flash.flash_attention_twin

    def counting_twin(*args, **kwargs):
        twin_calls.append(args[0].shape)
        return twin(*args, **kwargs)

    monkeypatch.setattr(flash, "flash_attention_twin", counting_twin)
    toks = tokens(jm.cfg, 1, 8192)
    jlg, jcaches = jengine.make_prefill(jm)(params, {"tokens": jnp.asarray(toks)})
    launches = flash.flash_attention.launches
    lg, caches = engine.make_prefill(tm)({"tokens": torch.from_numpy(toks)})
    assert twin_calls == [(1, 8192, tm.cfg.n_heads, tm.cfg.head_dim)] * tm.cfg.n_layers
    assert flash.flash_attention.launches == launches  # no kernel on the CPU
    close(lg.numpy(), jlg, 1e-4)
    got = convert.caches_to_numpy(tm.cfg, caches)
    close(got[0][0]["mix"]["v"], jcaches[0][0]["mix"]["v"], 1e-4)


def test_moe_decode_equals_forward():
    """deepseek-moe-16b's smoke config: decode's per-token expert gather
    against the prefill's sorted dispatch (nothing drops at its capacity
    factor of 4)."""
    tm = Model(dataclasses.replace(smoke_config("deepseek-moe-16b"), dtype="float32"),
               device="cpu", seed=2)
    T = 20
    toks = torch.from_numpy(tokens(tm.cfg, 2, T))
    full, _, _ = tm({"tokens": toks})
    _, caches = engine.make_prefill(tm)({"tokens": toks[:, : T - 3]})
    caches = engine.extend_caches(tm, caches, T - 3, T)
    step = engine.make_serve_step(tm)
    for i in range(3):
        pos = T - 3 + i
        lg, caches = step(caches, toks[:, pos:pos + 1], pos)
        close(lg[:, 0].numpy(), full[:, pos].numpy(), 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_prefill_extend_and_step_match_repro(dtype, monkeypatch):
    """In bfloat16, rows whose token's top-k margin is within bf16's
    precision (``torch_parity.BF16_TIE``) may route elsewhere in ``repro``
    and are left out of the logits' comparison, at most one in four (the
    caches are compared whole: they do not depend on the routing of this
    two-layer model)."""
    jm, params, tm = both("deepseek-moe-16b", dtype)
    B, T = 8, 17
    toks = np.random.default_rng(13).integers(0, jm.cfg.vocab, (B, T)).astype(np.int32)
    tol = 1e-4 if dtype == "float32" else 5e-2
    margins = router_margins(monkeypatch)

    def rows(margin):
        keep = np.ones(B, bool) if dtype == "float32" else (margin >= BF16_TIE).numpy()
        assert keep.mean() >= 0.75, keep
        return keep

    jlg, jcaches = jengine.make_prefill(jm)(params, {"tokens": jnp.asarray(toks[:, :-1])})
    lg, caches = engine.make_prefill(tm)({"tokens": torch.from_numpy(toks[:, :-1])})
    keep = rows(margins[-1].reshape(B, T - 1)[:, -1])
    close(convert.to_numpy(lg)[keep], np.asarray(jlg)[keep], tol)
    jcaches = jengine.extend_caches(jm, jcaches, T - 1, T + 4)
    caches = engine.extend_caches(tm, caches, T - 1, T + 4)
    jlg, jcaches = jengine.make_serve_step(jm)(params, jcaches, jnp.asarray(toks[:, -1:]),
                                               jnp.int32(T - 1))
    lg, caches = engine.make_serve_step(tm)(caches, torch.from_numpy(toks[:, -1:]), T - 1)
    keep = rows(margins[-1])
    close(convert.to_numpy(lg)[keep], np.asarray(jlg)[keep], tol)
    got = convert.caches_to_numpy(tm.cfg, caches)
    for g_seg, r_seg in zip(got, jcaches, strict=True):
        for g, r in zip(g_seg, r_seg, strict=True):
            for name in ("k", "v"):
                close(g["mix"][name], r["mix"][name], tol)


def test_moe_generate_matches_repro_tokens():
    jm, params, tm = both("deepseek-moe-16b", seed=0)
    toks = tokens(jm.cfg, 4, 8)
    want = jengine.generate(jm, params, {"tokens": jnp.asarray(toks)}, 6)
    got = engine.generate(tm, {"tokens": torch.from_numpy(toks)}, 6)
    assert got.dtype == torch.int32 and got.shape == (4, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_logits_topk_and_vocab_mask():
    logits = torch.full((2, 1, 100), -10.0)
    logits[:, 0, 95] = 50.0  # best token is in the pad zone
    logits[:, 0, 7] = 10.0
    gen = torch.Generator().manual_seed(0)
    tok = engine.sample_logits(logits, gen, top_k=5, real_vocab=90)
    assert tok.shape == (2, 1) and tok.dtype == torch.int32
    assert int(tok.max()) < 90  # the padded vocab is never sampled
    assert int(engine.sample_logits(logits, temperature=0.0, real_vocab=90)[0, 0]) == 7
    tok = engine.sample_logits(logits, gen, temperature=0.5, real_vocab=90)
    assert int(tok[0, 0]) == 7  # 20 logits above the rest at temperature 0.5


def test_extend_caches_refuses_ring_caches():
    """Ring caches, once refused (item 10.2), are re-slotted and rolled: a
    ring of 4 from a prompt of 4 grows to a window of 6 (each entry at slot
    p % 6, the others empty); a full ring of 6 from a prompt of 9 rolls by
    9 % 6 so that position p sits at slot p % 6."""
    tm = Model(dataclasses.replace(smoke_config("qwen3-4b"), sliding_window=6), device="cpu")
    k = torch.arange(4.0).reshape(1, 4, 1, 1).expand(1, 4, 2, 16)
    ring = [{"mix": {"k": k, "v": -k, "pos": torch.arange(4, dtype=torch.int32)}}]
    (out,) = engine.extend_caches(tm, ring, 4, 8)
    assert out["mix"]["pos"].tolist() == [0, 1, 2, 3, -1, -1]
    assert out["mix"]["k"][0, :, 0, 0].tolist() == [0, 1, 2, 3, 0, 0]
    assert torch.equal(out["mix"]["v"], -out["mix"]["k"])
    pos = torch.arange(3, 9, dtype=torch.int32)
    k = pos.float().reshape(1, 6, 1, 1).expand(1, 6, 2, 16)
    ring = [{"mix": {"k": k, "v": k, "pos": pos}}]
    (out,) = engine.extend_caches(tm, ring, 9, 12)
    assert out["mix"]["pos"].tolist() == [6, 7, 8, 3, 4, 5]
    assert out["mix"]["k"][0, :, 1, 3].tolist() == [6, 7, 8, 3, 4, 5]
