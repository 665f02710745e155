"""The port's MLA (deepseek-v3's latent attention) against ``repro`` on the
CPU: the mixer's prefill (chunked and flash), its uniform and per-slot
decode over the compressed cache, ``extend_caches``, the whole model's
logits and caches, decode against the teacher-forced forward, generation
and the continuous batcher, on the same numpy inputs and the same weights
(``convert.params_from_jax``).

Tolerances, as fractions of the reference's largest magnitude: 1e-5 for a
float32 layer and 1e-4 for a float32 model (the two differ only by the
order of accumulation); 5e-2 in bfloat16 (``tests/test_serve.py``'s), where
the flash branch's twin keeps p in float32 and ``repro``'s pair schedule
rounds it to bfloat16, and where, in the whole model, tokens whose top-k
router margin is within bfloat16's precision (``torch_parity.BF16_TIE``)
may route elsewhere and are left out of the logits' comparison.
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
from repro.serve import engine as jengine
from repro.serve.batching import ContinuousBatcher as JBatcher
from repro.serve.batching import Request as JRequest
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.kernels import flash
from repro_torch.models import attention
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.serve import engine
from repro_torch.serve.batching import ContinuousBatcher, Request
from torch_parity import BF16_TIE, router_margins

ARCH = "deepseek-v3-671b"
LAYER_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# MLA's published head widths (qk_nope_dim + qk_rope_dim = 192, v_head_dim
# = 128) on the smoke config's two heads: the flash branch's shape
MLA_WIDTHS = dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def f32(a) -> np.ndarray:
    """An array as float32; the port's bfloat16 arrives as uint16 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def close(got, want, rel):
    got, want = f32(convert.to_numpy(got) if isinstance(got, torch.Tensor) else got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, scale)


def cfgs(dtype="float32", **kw):
    """The same smoke config from both packages."""
    return (dataclasses.replace(jsmoke(ARCH), dtype=dtype, **kw),
            dataclasses.replace(smoke_config(ARCH), dtype=dtype, **kw))


def mla_pair(dtype="float32", seed=5, **kw):
    """``repro``'s MLA parameters and the port's ``attention.MLA`` holding
    them."""
    jc, tc = cfgs(dtype, **kw)
    jp = jattn.init_mla(jax.random.key(seed), jc, None)
    p = attention.MLA(tc, None, "meta").to_empty(device="cpu")
    p.load_state_dict({k: convert.to_tensor(np.asarray(v), "cpu") for k, v in jp.items()})
    return jc, tc, jp, p


def both(dtype="float32", seed=1, **kw):
    jc, tc = cfgs(dtype, **kw)
    jm = JModel(jc)
    params = jm.init(jax.random.key(seed))
    tm = Model(tc, device="cpu")
    tm.load_state_dict(convert.params_from_jax(tc, params))
    return jm, params, tm


def inputs(tc, shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(tc.dtype), torch.from_numpy(x).to(getattr(torch, tc.dtype))


def tokens(cfg, B, T, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


# ------------------------------------------------------------------ params


def test_mla_leaves_are_repros():
    """The module's parameters are ``init_mla``'s leaves: names, shapes,
    dtypes (the two latent norms in float32), and a block of a whole model
    carries them under ``layers.<i>.mix``."""
    jc, tc, jp, p = mla_pair("bfloat16")
    got = {k: (tuple(v.shape), v.dtype) for k, v in p.state_dict().items()}
    want = {k: (v.shape, torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
            for k, v in jp.items()}
    assert got == want
    assert list(got) == ["wq_a", "q_ln", "wq_b", "wkv_a", "kv_ln", "wk_b", "wv_b", "wo"]
    tm = Model(tc, device="cpu")
    assert all(isinstance(b.mix, attention.MLA) for b in tm.layers)
    jm = JModel(jc)
    names = set(convert.params_from_jax(tc, jm.init(jax.random.key(0))))
    assert names == set(tm.state_dict())


def test_mla_init_scales_follow_repro():
    """Seeded weights at ``repro``'s scales: each projection's std is its
    fan-in ** -0.5 (within 5% at these sizes), the latent norms are ones."""
    _, tc = cfgs()
    p = attention.MLA(tc, torch.Generator().manual_seed(0), "cpu")
    fan_in = {"wq_a": tc.d_model, "wq_b": tc.q_lora_rank, "wkv_a": tc.d_model,
              "wk_b": tc.kv_lora_rank, "wv_b": tc.kv_lora_rank,
              "wo": tc.n_heads * tc.v_head_dim}
    for name, n in fan_in.items():
        std = float(getattr(p, name).std())
        assert abs(std * n ** 0.5 - 1) < 0.05, (name, std)
    assert torch.equal(p.q_ln, torch.ones(tc.q_lora_rank))
    assert torch.equal(p.kv_ln, torch.ones(tc.kv_lora_rank))


# ------------------------------------------------------------------ prefill


@pytest.mark.parametrize("S", [40, 1024])  # one query chunk, and two of Q_CHUNK
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_chunked_matches_repro(dtype, S):
    jc, tc, jp, p = mla_pair(dtype)
    xj, xt = inputs(tc, (2, S, tc.d_model))
    want, wc = jattn.mla_forward(xj, jp, jc, None, cache={})
    got, gc = attention.mla_forward(xt, p, tc, cache={})
    close(got, want, LAYER_TOL[dtype])
    for name in ("c_kv", "k_pe"):
        assert gc[name].shape == wc[name].shape
        close(gc[name], wc[name], LAYER_TOL[dtype])
    train, none = attention.mla_forward(xt, p, tc)  # no cache: training
    assert none is None and torch.equal(train, got)


@pytest.mark.parametrize("inference", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_flash_branch_matches_repro(dtype, inference, monkeypatch):
    """FLASH_MIN_SEQ lowered to 1024 in both packages, MLA's published
    (192, 128) head widths: at prefill (a cache given) the port's
    ``flash_attention`` runs its twin on the CPU and ``repro``'s
    ``_flash_attn`` its pair schedule (``_flash_attn_pairs``, what it runs
    off the TPU); in training both run their differentiable flash."""
    monkeypatch.setattr(jattn, "FLASH_MIN_SEQ", 1024)
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 1024)
    jc, tc, jp, p = mla_pair(dtype, flash_attention=True, **MLA_WIDTHS)
    calls, twin = [], flash.flash_attention_twin

    def counting_twin(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return twin(q, k, v, **kw)

    monkeypatch.setattr(flash, "flash_attention_twin", counting_twin)
    xj, xt = inputs(tc, (1, 1024, tc.d_model), seed=1)
    cache = {} if inference else None
    want, _ = jattn.mla_forward(xj, jp, jc, None, cache=cache)
    got, _ = attention.mla_forward(xt, p, tc, cache=cache)
    H = tc.n_heads
    assert calls == ([((1, 1024, H, 192), (1, 1024, H, 192), (1, 1024, H, 128))]
                     if inference else [])
    close(got, want, LAYER_TOL[dtype])


def test_mla_flash_at_smoke_widths_is_refused():
    """The smoke config's (24, 16) widths are no pair the kernel takes: the
    flash branch raises on the CPU as on the card, naming the pairs."""
    _, tc, _, p = mla_pair(flash_attention=True)
    x = torch.zeros((1, attention.FLASH_MIN_SEQ, tc.d_model))
    with pytest.raises(ValueError, match=r"\(dqk, dv\) not in"):
        attention.mla_forward(x, p, tc, cache={})


# ------------------------------------------------------------------- decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_uniform_decode_matches_repro(dtype):
    """A prefill of 12 into caches of 16, then three decode steps at one
    position for the batch: outputs and compressed caches against
    ``repro``'s absorbed path; the port writes into the cache in place."""
    jc, tc, jp, p = mla_pair(dtype)
    B, L, S_max = 2, 12, 16
    xj, xt = inputs(tc, (B, L + 3, tc.d_model), seed=2)
    _, wc = jattn.mla_forward(xj[:, :L], jp, jc, None, cache={})
    _, gc = attention.mla_forward(xt[:, :L], p, tc, cache={})
    wc = {k: jnp.pad(v, ((0, 0), (0, S_max - L), (0, 0))) for k, v in wc.items()}
    gc = engine.extend_caches(None, [{"mix": gc}], L, S_max)[0]["mix"]
    for i in range(3):
        pos = L + i
        want, wc = jattn.mla_forward(xj[:, pos:pos + 1], jp, jc, None, cache=wc, decode=True,
                                     positions=jnp.asarray([pos], jnp.int32))
        buf = gc["c_kv"]
        got, gc = attention.mla_forward(xt[:, pos:pos + 1], p, tc, cache=gc, decode=True,
                                        positions=torch.tensor([pos]))
        assert gc["c_kv"] is buf  # in place
        close(got, want, LAYER_TOL[dtype])
        for name in ("c_kv", "k_pe"):
            close(gc[name], wc[name], LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_per_slot_decode_matches_repro(dtype):
    """Three slots decoding at positions 4, -3 (counted from the end, as
    jax indexes) and 16 (past the cache: dropped), against ``repro``'s
    per-slot path: outputs and caches; the dropped row keeps its cache."""
    jc, tc, jp, p = mla_pair(dtype, seed=6)
    rng = np.random.default_rng(4)
    B, S_max = 3, 16
    xj, xt = inputs(tc, (B, 1, tc.d_model), seed=7)
    old = {"c_kv": rng.standard_normal((B, S_max, tc.kv_lora_rank)).astype(np.float32),
           "k_pe": rng.standard_normal((B, S_max, tc.qk_rope_dim)).astype(np.float32)}
    pos = np.array([4, -3, 16], np.int32)
    want, wc = jattn.mla_forward(
        xj, jp, jc, None, decode=True, positions=jnp.asarray(pos),
        cache={k: jnp.asarray(v).astype(jc.dtype) for k, v in old.items()})
    dt = getattr(torch, dtype)
    got, gc = attention.mla_forward(xt, p, tc, decode=True, positions=torch.from_numpy(pos),
                                    cache={k: torch.from_numpy(v.copy()).to(dt)
                                           for k, v in old.items()})
    close(got, want, LAYER_TOL[dtype])
    for name in ("c_kv", "k_pe"):
        close(gc[name], wc[name], LAYER_TOL[dtype])
        np.testing.assert_array_equal(gc[name][2].float().numpy(),
                                      torch.from_numpy(old[name][2]).to(dt).float().numpy())
        assert not torch.equal(gc[name][1, S_max - 3].float(),
                               torch.from_numpy(old[name][1, S_max - 3]).to(dt).float())


def test_mla_cache_init_and_block_cache():
    _, tc = cfgs("bfloat16")
    c = attention.init_mla_cache(tc, 2, 9)
    assert c["c_kv"].shape == (2, 9, tc.kv_lora_rank) and c["k_pe"].shape == (2, 9, tc.qk_rope_dim)
    assert c["c_kv"].dtype == torch.bfloat16 and not c["c_kv"].any()
    spec = tc.layer_list()[0]
    assert spec.mixer == "mla"
    bc = tfm.init_block_cache(spec, tc, 2, 9)
    assert set(bc) == {"mix"} and set(bc["mix"]) == {"c_kv", "k_pe"}


# ----------------------------------------------------------- serving engine


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extend_caches_matches_repro(dtype):
    jm, params, tm = both(dtype)
    toks = tokens(tm.cfg, 2, 11)
    _, jc = jengine.make_prefill(jm)(params, {"tokens": jnp.asarray(toks)})
    _, tc = engine.make_prefill(tm)({"tokens": torch.from_numpy(toks)})
    jc = jengine.extend_caches(jm, jc, 11, 19)
    tc = engine.extend_caches(tm, tc, 11, 19)
    assert tc[0]["mix"]["c_kv"].shape == (2, 19, tm.cfg.kv_lora_rank)
    assert not tc[0]["mix"]["k_pe"][:, 11:].any()
    got = convert.caches_to_numpy(tm.cfg, tc)
    for g_seg, r_seg in zip(got, jc, strict=True):
        for g, r in zip(g_seg, r_seg, strict=True):
            for name in ("c_kv", "k_pe"):
                close(g["mix"][name], r["mix"][name], MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_matches_repro(dtype, monkeypatch):
    jm, params, tm = both(dtype)
    toks = tokens(tm.cfg, 2, 24, seed=12)
    want, _, jaux = jm.forward(params, {"tokens": jnp.asarray(toks)})
    margins = router_margins(monkeypatch)
    got, _, aux = tm({"tokens": torch.from_numpy(toks)})
    keep = np.ones((2, 24), bool)
    if dtype == "bfloat16":
        keep = (margins[0] >= BF16_TIE).numpy().reshape(2, 24)
        assert keep.mean() >= 0.75
    close(convert.to_numpy(got)[keep], np.asarray(want)[keep], MODEL_TOL[dtype])
    assert abs(float(aux) - float(jaux)) <= MODEL_TOL[dtype] * float(jaux)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_extend_and_step_match_repro(dtype, monkeypatch):
    """Prefill, extend and two decode steps, logits and every layer's
    compressed caches against ``repro``'s (the caches do not depend on the
    routing of this two-layer model; logits rows whose router margin is
    within bf16's precision are left out)."""
    jm, params, tm = both(dtype)
    B, T = 8, 17
    toks = tokens(tm.cfg, B, T, seed=13)
    tol = MODEL_TOL[dtype]
    margins = router_margins(monkeypatch)

    def rows(margin):
        keep = np.ones(B, bool) if dtype == "float32" else (margin >= BF16_TIE).numpy()
        assert keep.mean() >= 0.75, keep
        return keep

    def same_caches(port, ref):
        got = convert.caches_to_numpy(tm.cfg, port)
        for g_seg, r_seg in zip(got, ref, strict=True):
            for g, r in zip(g_seg, r_seg, strict=True):
                for name in ("c_kv", "k_pe"):
                    close(g["mix"][name], r["mix"][name], tol)

    jlg, jc = jengine.make_prefill(jm)(params, {"tokens": jnp.asarray(toks[:, :-2])})
    lg, tc = engine.make_prefill(tm)({"tokens": torch.from_numpy(toks[:, :-2])})
    keep = rows(margins[-1].reshape(B, T - 2)[:, -1])
    close(convert.to_numpy(lg)[keep], np.asarray(jlg)[keep], tol)
    same_caches(tc, jc)
    jc = jengine.extend_caches(jm, jc, T - 2, T + 4)
    tc = engine.extend_caches(tm, tc, T - 2, T + 4)
    for pos in (T - 2, T - 1):
        jlg, jc = jengine.make_serve_step(jm)(params, jc, jnp.asarray(toks[:, pos:pos + 1]),
                                              jnp.int32(pos))
        lg, tc = engine.make_serve_step(tm)(tc, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        keep = rows(margins[-1])
        close(convert.to_numpy(lg)[keep], np.asarray(jlg)[keep], tol)
        same_caches(tc, jc)


@pytest.mark.parametrize("n_pre", [1, 3])
def test_decode_equals_forward(n_pre):
    """``tests/test_serve.py``'s ``test_decode_equals_forward`` (one step)
    and ``test_multistep_decode`` (three) for deepseek-v3, on the port
    alone: decode's absorbed products over the compressed cache against
    the teacher-forced forward's expanded attention (nothing drops at the
    smoke config's capacity factor of 4)."""
    tm = Model(dataclasses.replace(smoke_config(ARCH), dtype="float32"), device="cpu", seed=2)
    T = 20
    toks = torch.from_numpy(tokens(tm.cfg, 2, T))
    full, _, _ = tm({"tokens": toks})
    _, caches = engine.make_prefill(tm)({"tokens": toks[:, :T - n_pre]})
    caches = engine.extend_caches(tm, caches, T - n_pre, T)
    step = engine.make_serve_step(tm)
    for i in range(n_pre):
        pos = T - n_pre + i
        lg, caches = step(caches, toks[:, pos:pos + 1], pos)
        close(lg[:, 0], convert.to_numpy(full[:, pos]), MODEL_TOL["float32"])


def test_generate_matches_repro_tokens():
    jm, params, tm = both(seed=0)
    toks = tokens(tm.cfg, 4, 8, seed=14)
    want = jengine.generate(jm, params, {"tokens": jnp.asarray(toks)}, 6)
    got = engine.generate(tm, {"tokens": torch.from_numpy(toks)}, 6)
    assert got.dtype == torch.int32 and got.shape == (4, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_in_bf16_runs_at_mla_widths():
    """bfloat16 at MLA's published head widths: prefill, extend and decode
    give finite logits and in-vocabulary tokens."""
    tm = Model(dataclasses.replace(smoke_config(ARCH), dtype="bfloat16", **MLA_WIDTHS),
               device="cpu", seed=3)
    out = engine.generate(tm, {"tokens": torch.from_numpy(tokens(tm.cfg, 2, 10))}, 4)
    assert out.shape == (2, 4) and int(out.max()) < tm.cfg.vocab and int(out.min()) >= 0


# ----------------------------------------------------------------- batching


@pytest.mark.parametrize("lengths", [(4, 6), (5, 9, 7)])
def test_batched_mla_matches_repro(lengths):
    """``tests/test_batching.py::test_batched_mla_arch`` ported: the port's
    batcher (two slots, so three requests re-admit one) gives each
    request's tokens alone (``generate``) and ``repro``'s batcher's."""
    jm, params, tm = both(seed=2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tm.cfg.vocab, L).astype(np.int32) for L in lengths]
    n_new = 4
    got = ContinuousBatcher(tm, n_slots=2, s_max=16).run(
        [Request(i, p, n_new) for i, p in enumerate(prompts)])
    want = JBatcher(jm, params, n_slots=2, s_max=16).run(
        [JRequest(i, p, n_new) for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        alone = engine.generate(tm, {"tokens": torch.from_numpy(p[None])}, n_new)[0].tolist()
        assert got[i] == want[i] == alone, i


def test_batcher_splices_compressed_caches():
    """Admission writes a prompt's (c_kv, k_pe) into its slot's row, zero
    past the prompt, and leaves the other slot's row alone."""
    tm = Model(dataclasses.replace(smoke_config(ARCH), dtype="float32"), device="cpu", seed=4)
    b = ContinuousBatcher(tm, n_slots=2, s_max=12)
    prompt = tokens(tm.cfg, 1, 5, seed=15)[0]
    b.submit(Request(0, prompt, 3))
    b._admit()
    _, pre = engine.make_prefill(tm)({"tokens": torch.from_numpy(prompt[None])})
    for layer, want in zip(b.caches, pre, strict=True):
        for name in ("c_kv", "k_pe"):
            row = layer["mix"][name]
            assert torch.equal(row[0, :5], want["mix"][name][0])
            assert not row[0, 5:].any() and not row[1].any()
    assert b.positions.tolist() == [5, -1]
