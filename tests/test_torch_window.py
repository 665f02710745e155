"""The port's sliding-window attention (recurrentgemma's local attention)
against ``repro`` on the CPU: the banded chunked prefill, the ring cache
prefill leaves, the ring's decode across several wraps,
``init_gqa_cache(window=)``, ``serve.engine.extend_caches`` down both of
its ring branches (re-slot and roll), and the recurrentgemma-9b smoke
model end to end: prefill, greedy generation and one train step's loss and
gradients, on the same numpy inputs and the same weights
(``convert.params_from_jax``). The smoke window is 32.

Tolerance: float32 within 1e-5 x the reference's largest magnitude (the
two differ by the order of accumulation); ring positions exactly.
``repro``'s functions run compiled (``jax.jit``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke
from repro.models import attention as jattn
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models import attention
from repro_torch.serve import engine
from torch_model_parity import TOL, both, cfgs, close, generate_both, loss_and_grads_both

ARCH = "recurrentgemma-9b"
WINDOW = 32


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def attn_pair(seed=5):
    """``repro``'s attention parameters (recurrentgemma's MQA: 4 query
    heads, 1 kv head of 16) and the port's ``attention.Attention`` holding
    them."""
    jc, tc = cfgs(ARCH)
    jp = jax.jit(functools.partial(jattn.init_attention, cfg=jc, axes=None))(
        jax.random.key(seed))
    p = attention.Attention(tc, None, "meta").to_empty(device="cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jc, tc, jp, p


def jgqa(jc, **kw):
    """``repro``'s ``gqa_forward`` compiled, with the window's settings."""
    return jax.jit(functools.partial(jattn.gqa_forward, cfg=jc, axes=None, window=WINDOW,
                                     rope=True, **kw))


def test_smoke_window_is_32():
    assert smoke_config(ARCH).sliding_window == jsmoke(ARCH).sliding_window == WINDOW


@pytest.mark.parametrize("S", [40, 1024])
def test_chunked_attn_bands_keys_as_repro(S, monkeypatch):
    """S = 40: one query chunk under the banded mask; S = 1024: two chunks
    of 512, each against its band of 32 + 512 = 544 < 1024 keys."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 1, 16)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jc, _ = cfgs(ARCH)
    want = jax.jit(functools.partial(jattn._chunked_attn, cfg=jc, causal=True, window=WINDOW,
                                     scale=0.25))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(pos),
        k_positions=jnp.asarray(pos))
    seen = []
    real = attention._grouped_attn
    monkeypatch.setattr(attention, "_grouped_attn",
                        lambda q_, k_, *a: seen.append(k_.shape[1]) or real(q_, k_, *a))
    got = attention._chunked_attn(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
        q_positions=torch.from_numpy(pos).long(), k_positions=torch.from_numpy(pos).long(),
        scale=0.25, window=WINDOW)
    close(got, want)
    assert seen == ([S] if S <= attention.Q_CHUNK else [WINDOW + attention.Q_CHUNK] * 2)


def test_band_mask_limits_each_query_to_the_window():
    """Brute force: query i sees keys i - 31 .. i, as in ``repro``."""
    pos = torch.arange(70)
    m = attention._causal_mask(pos, pos, WINDOW)
    i, j = torch.meshgrid(pos, pos, indexing="ij")
    assert torch.equal(m, (j <= i) & (i - j < WINDOW))
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(jattn._causal_mask(jnp.arange(70), jnp.arange(70), WINDOW)))


@pytest.mark.parametrize("S", [16, 48])
def test_prefill_ring_cache_matches_repro(S):
    """The prompt's last min(32, S) keys and values, rope'd, and their
    positions (int32)."""
    jc, tc, jp, p = attn_pair()
    x = np.random.default_rng(S).standard_normal((2, S, tc.d_model)).astype(np.float32)
    jo, jcache = jgqa(jc)(jnp.asarray(x), jp,
                          cache=jattn.init_gqa_cache(jc, None, 2, S, WINDOW))
    to, tcache = attention.gqa_forward(torch.from_numpy(x), p, tc, window=WINDOW, rope=True,
                                       cache=attention.init_gqa_cache(tc, 2, S, WINDOW))
    close(to, jo)
    W = min(WINDOW, S)
    assert tcache["k"].shape == (2, W, 1, 16) and tcache["pos"].dtype == torch.int32
    close(tcache["k"], jcache["k"])
    close(tcache["v"], jcache["v"])
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_ring_decode_across_wraps_matches_repro():
    """40 decode steps from an empty ring of 32: the writes wrap once and a
    quarter; each step's output and, at the end, the ring and its
    positions."""
    jc, tc, jp, p = attn_pair(seed=7)
    x = np.random.default_rng(7).standard_normal((2, 40, tc.d_model)).astype(np.float32)
    step = jgqa(jc, decode=True)
    jcache = jattn.init_gqa_cache(jc, None, 2, 64, WINDOW)
    tcache = attention.init_gqa_cache(tc, 2, 64, WINDOW)
    for t in range(40):
        jo, jcache = step(jnp.asarray(x[:, t:t + 1]), jp, cache=jcache,
                          positions=jnp.asarray([t], jnp.int32))
        to, tcache = attention.gqa_forward(torch.from_numpy(x[:, t:t + 1]), p, tc,
                                           window=WINDOW, rope=True, cache=tcache,
                                           decode=True, positions=torch.tensor([t]))
        close(to, jo)
    close(tcache["k"], jcache["k"])
    close(tcache["v"], jcache["v"])
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    assert sorted(tcache["pos"].tolist()) == list(range(8, 40))


def test_ring_decode_refuses_per_slot_positions():
    """One position for the whole batch only: the batcher refuses windowed
    configs, and ``repro``'s ring write takes a scalar."""
    _, tc, _, p = attn_pair()
    with pytest.raises(ValueError, match="sliding window"):
        attention.gqa_forward(torch.zeros(2, 1, tc.d_model), p, tc, window=WINDOW,
                              cache=attention.init_gqa_cache(tc, 2, 8, WINDOW), decode=True,
                              positions=torch.tensor([3, 4]))


@pytest.mark.parametrize("S_max", [8, 64])
def test_init_gqa_cache_with_a_window_matches_repro(S_max):
    """A ring of min(32, S_max) zeroed entries, every position -1."""
    jc, tc = cfgs(ARCH, "bfloat16")
    want = jattn.init_gqa_cache(jc, None, 3, S_max, WINDOW)
    got = attention.init_gqa_cache(tc, 3, S_max, WINDOW)
    assert set(got) == set(want) == {"k", "v", "pos"}
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape == (3, min(WINDOW, S_max), 1, 16)
        assert got[name].dtype == torch.bfloat16 and float(got[name].abs().sum()) == 0
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    assert got["pos"].dtype == torch.int32


# ------------------------------------------------------------ whole model


@pytest.fixture(scope="module")
def models():
    return both(ARCH)


@pytest.mark.parametrize("prefill_len", [16, 48], ids=["reslot", "roll"])
def test_extend_caches_matches_repro(models, prefill_len):
    """A prefill of 16 < 32 fills a ring of 16, which grows to 32 with each
    entry at slot p % 32 (re-slot); one of 48 keeps its last 32, rolled by
    48 % 32. The recurrent caches (conv, h) pass through unchanged. Every
    layer's cache in ``repro``'s layout through ``caches_to_numpy``."""
    jm, params, tm = models
    toks = np.random.default_rng(prefill_len).integers(0, tm.cfg.vocab, (2, prefill_len))
    toks = toks.astype(np.int32)
    _, jc = jax.jit(jengine.make_prefill(jm))(params, {"tokens": jnp.asarray(toks)})
    want = jengine.extend_caches(jm, jc, prefill_len, prefill_len + 24)
    _, tcaches = engine.make_prefill(tm)({"tokens": torch.from_numpy(toks)})
    got = engine.extend_caches(tm, tcaches, prefill_len, prefill_len + 24)
    for c, g, spec in zip(tcaches, got, tm.cfg.layer_list(), strict=True):
        if spec.mixer == "rglru":
            assert g["mix"] is c["mix"]
        else:
            assert g["mix"]["k"].shape[1] == WINDOW
    got_np = convert.caches_to_numpy(tm.cfg, got)
    want_np = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got_np) == jax.tree.structure(want_np)
    for path, w in jax.tree_util.tree_leaves_with_path(want_np):
        g = functools.reduce(lambda t, k: t[getattr(k, "idx", getattr(k, "key", None))],
                             path, got_np)
        if path[-1].key == "pos":
            np.testing.assert_array_equal(g, w)
        else:
            close(g, w)
    pos = want_np[0][2]["mix"]["pos"][0]  # the first local-attention layer
    assert sorted(p for p in pos.tolist() if p >= 0) == list(
        range(max(0, prefill_len - WINDOW), prefill_len))
    assert all(p < 0 or p % WINDOW == s for s, p in enumerate(pos.tolist()))


@pytest.fixture(scope="module")
def rg_generated():
    """recurrentgemma's smoke model: 2 prompts of 1024 tokens (banded local
    attention, four scan chunks), 24 new."""
    return generate_both(ARCH, 1024, 24)


def test_recurrentgemma_generates_repros_tokens(rg_generated):
    (want, _), (got, _) = rg_generated
    assert got.dtype == np.int32 and got.shape == (2, 24)
    np.testing.assert_array_equal(got, want)


def test_recurrentgemma_prefill_and_decode_logits_match_repro(rg_generated):
    (_, jlogs), (_, tlogs) = rg_generated
    assert len(jlogs) == len(tlogs) == 24
    for got, want in zip(tlogs, jlogs, strict=True):
        close(got, want)


def test_recurrentgemma_scales_its_embeddings(models):
    """The embedding rows times sqrt(d_model) = 8, a scalar of the
    activation dtype, as ``repro``'s; the logits read the tied table."""
    jm, params, tm = models
    toks = np.array([[3, 5, 511]], np.int32)
    x = tm._embed_in({"tokens": torch.from_numpy(toks)}, torch.arange(3))
    assert torch.equal(x, tm.embed.table[torch.from_numpy(toks)] * 8.0)
    want = jm._embed_in(params, {"tokens": jnp.asarray(toks)}, jnp.arange(3))
    np.testing.assert_array_equal(x.numpy(), np.asarray(want))
    assert tm.lm_head is None


def test_recurrentgemma_loss_and_gradients_match_jax_grad():
    """S = 512: two scan chunks, one query chunk under the band; each
    leaf's gradient within TOL x its largest |value| in ``repro``."""
    (jl, jmet, want), (tl, tmet, got) = loss_and_grads_both(ARCH)
    assert tl == pytest.approx(jl, rel=TOL)
    for k in ("nll", "zloss", "accuracy"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=TOL, abs=1e-7), k
    assert set(got) == set(want)
    for name, g in got.items():
        close(g, want[name].numpy())
