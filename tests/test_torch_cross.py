"""The port's cross-attention, whisper's encoder and the VLM's vision
memory (``models/attention.py``'s cross branch, ``models/transformer.py``'s
cross blocks, ``models/model.py``'s ``Encoder`` and ``_memory``) against
``repro`` on the CPU, on the smoke configs of whisper-base and
llama-3.2-vision-11b: the mixer's prefill and decode, the encoder,
``Model.forward``, decode against the full forward, ``engine.generate``,
one micro-batch's loss and gradients, the conversions, a flash prefill at
S = 8192 and the batcher's refusal.

The VLM's cross gates are zero at init (tanh(0) = 0 would hide the whole
cross path) and whisper's biases are zero too, so every model here gets
seeded nonzero gates, biases and layernorm biases in ``repro``'s tree
before the weights are carried (``torch_model_parity.nonzero_params``).
Tolerances: float32 within 1e-4 x the reference's largest magnitude,
bfloat16 within 5e-2, as ``tests/test_torch_models.py`` holds the model
tier.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.serve import batching as jbatching
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.kernels import flash
from repro_torch.models import attention
from repro_torch.serve import batching, engine
from torch_model_parity import (
    as_jax, as_torch, both, cfgs, close, generate_both, loss_and_grads_both, memory_inputs,
    nonzero_params,
)

ARCHS = ["whisper-base", "llama-3.2-vision-11b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _no_grad():
    """Every case but the gradients' compares forward passes, under
    ``torch.no_grad()`` as serving runs (the loss case turns grad on)."""
    with torch.no_grad():
        yield


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def normal(rng, shape, dtype) -> np.ndarray:
    return rng.standard_normal(shape).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)


def tt(a) -> torch.Tensor:
    return convert.to_tensor(a, "cpu")


# ------------------------------------------------------------ the mixer


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_cross_prefill_then_decode_matches_repro(arch, dtype):
    """``gqa_forward`` with ``memory``: the output and the ``ck``/``cv``
    cache at prefill, then a decode step that reads the cache and returns
    it unchanged (whisper: the biases; the VLM: the gate)."""
    jc, tc = cfgs(arch, dtype)
    p = nonzero_params(jattn.init_attention(jax.random.key(4), jc, None, cross=True), 4)
    layer = attention.Attention(tc, None, "cpu", cross=True)
    layer.load_state_dict({k: tt(np.asarray(v)) for k, v in p.items()})
    assert (layer.gate is not None) == bool(tc.n_vision_tokens)
    assert (layer.bq is not None) == tc.attn_bias
    rng = np.random.default_rng(5)
    B, S, M, d = 2, 12, 20, tc.d_model
    mem, x = normal(rng, (B, M, d), dtype), normal(rng, (B, S + 1, d), dtype)
    zeros = jnp.zeros((B, M, tc.n_kv_heads, tc.head_dim), jc.dtype)
    jout, jcache = jattn.gqa_forward(jnp.asarray(x[:, :S]), p, jc, None, causal=False,
                                     cache={"ck": zeros, "cv": zeros}, memory=jnp.asarray(mem))
    tz = torch.zeros((B, M, tc.n_kv_heads, tc.head_dim), dtype=getattr(torch, dtype))
    out, cache = attention.gqa_forward(tt(x)[:, :S], layer, tc, causal=False,
                                       cache={"ck": tz, "cv": tz.clone()}, memory=tt(mem))
    close(out, jout, TOL[dtype])
    for name in ("ck", "cv"):
        assert cache[name].shape == (B, M, tc.n_kv_heads, tc.head_dim)
        close(cache[name], jcache[name], TOL[dtype])
    held = {k: v.clone() for k, v in cache.items()}
    jout, jc2 = jattn.gqa_forward(jnp.asarray(x[:, S:]), p, jc, None, causal=False,
                                  positions=jnp.asarray([S]), cache=jcache)
    out, c2 = attention.gqa_forward(tt(x)[:, S:], layer, tc, causal=False,
                                    positions=torch.tensor([S]), cache=cache, decode=True)
    close(out, jout, TOL[dtype])
    assert c2 is cache and all(torch.equal(cache[k], held[k]) for k in held)
    assert jc2 is jcache


def test_cross_gate_scales_the_output():
    """tanh(gate): a zero gate adds nothing, the seeded one does."""
    _, tc = cfgs("llama-3.2-vision-11b")
    layer = attention.Attention(tc, torch.Generator().manual_seed(2), "cpu", cross=True)
    x, mem = torch.randn(1, 4, tc.d_model), torch.randn(1, 6, tc.d_model)
    out, _ = attention.gqa_forward(x, layer, tc, causal=False, memory=mem)
    assert float(layer.gate) == 0.0 and torch.equal(out, torch.zeros_like(out))
    layer.gate.fill_(0.7)
    gated, _ = attention.gqa_forward(x, layer, tc, causal=False, memory=mem)
    layer.gate = None
    plain, _ = attention.gqa_forward(x, layer, tc, causal=False, memory=mem)
    torch.testing.assert_close(gated, np.tanh(0.7) * plain)


# ------------------------------------------------------------ the encoder


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S_enc", [512, 1024])
def test_whisper_encoder_matches_repro(S_enc, dtype):
    """``_memory``: the frames plus their sinusoidal embedding through the
    encoder's non-causal blocks (one query chunk at 512, two at 1024) and
    its final norm."""
    jm, params, tm = both("whisper-base", dtype, seed=6, nonzero=True)
    batch = memory_inputs(tm.cfg, 2, 6, S_enc)
    want = jax.jit(jm._memory)(params, as_jax(batch))
    got = tm._memory(as_torch(batch))
    assert got.shape == (2, S_enc, tm.cfg.d_model) and got.dtype == getattr(torch, dtype)
    close(got, want, TOL[dtype])


def test_1500_encoder_frames_are_refused_by_both():
    """whisper's real 1500 frames: past one query chunk the sequence must
    be a multiple of Q_CHUNK = 512 in ``repro`` (AssertionError) and in the
    port (ValueError); neither pads."""
    jm, params, tm = both("whisper-base", seed=6)
    batch = memory_inputs(tm.cfg, 1, 6, 1500)
    with pytest.raises(AssertionError, match="divisible by Q_CHUNK"):
        jm._memory(params, as_jax(batch))
    with pytest.raises(ValueError, match="divisible by Q_CHUNK"):
        tm._memory(as_torch(batch))


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_repro(arch, dtype):
    """``Model.forward`` in its training form (no caches): the logits and
    the aux loss."""
    jm, params, tm = both(arch, dtype, seed=7, nonzero=True)
    batch = {"tokens": tokens(tm.cfg, 2, 40, 7), **memory_inputs(tm.cfg, 2, 7, 48)}
    jlogits, _, jaux = jax.jit(jm.forward)(params, as_jax(batch))
    logits, caches, aux = tm(as_torch(batch))
    assert caches is None and logits.shape == (2, 40, tm.vocab_padded)
    close(logits, jlogits, TOL[dtype])
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward(arch):
    """``tests/test_serve.py``'s check on the port alone, in float32: a
    prefill of T - 3 tokens and three decode steps against the
    teacher-forced forward with the same memory, and each step's logits
    against ``repro``'s."""
    jm, params, tm = both(arch, seed=8, nonzero=True)
    T = 20
    batch = {"tokens": tokens(tm.cfg, 2, T, 8), **memory_inputs(tm.cfg, 2, 8, 24)}
    tb, jb = as_torch(batch), as_jax(batch)
    full, _, _ = tm(tb)
    _, caches = engine.make_prefill(tm)({**tb, "tokens": tb["tokens"][:, :T - 3]})
    _, jcaches = jengine.make_prefill(jm)(params, {**jb, "tokens": jb["tokens"][:, :T - 3]})
    caches = engine.extend_caches(tm, caches, T - 3, T)
    jcaches = jengine.extend_caches(jm, jcaches, T - 3, T)
    step, jstep = engine.make_serve_step(tm), jax.jit(jengine.make_serve_step(jm))
    for i in range(3):
        pos = T - 3 + i
        lg, caches = step(caches, tb["tokens"][:, pos:pos + 1], pos)
        jlg, jcaches = jstep(params, jcaches, jb["tokens"][:, pos:pos + 1], jnp.int32(pos))
        close(lg[:, 0], full[:, pos].numpy(), TOL["float32"])
        close(lg, jlg, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_repro(arch):
    """``engine.generate`` of 2 prompts of 24 tokens (whisper: 64 frames)
    and 8 new: the same tokens, and every prefill's and step's logits
    within 1e-4 x max."""
    (want, jlogs), (got, tlogs) = generate_both(arch, 24, 8, seed=9, nonzero=True)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    assert len(jlogs) == len(tlogs) == 8
    for g, w in zip(tlogs, jlogs, strict=True):
        close(g, w, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_grad(arch):
    """One micro-batch of 2 x 512 tokens (whisper: 512 frames): the loss,
    its metrics and every gradient, the encoder's and the gates' included,
    within 1e-4 x the largest |value| of ``repro``'s. A key bias's gradient
    is zero (it shifts a query's scores by one constant, which the softmax
    drops): on both sides it must be rounding noise, under 1e-6 x the
    largest gradient of the model."""
    with torch.enable_grad():
        (jl, jmet, want), (tl, tmet, got) = loss_and_grads_both(arch, seed=10, nonzero=True)
    assert tl == pytest.approx(jl, rel=TOL["float32"])
    for k in ("nll", "zloss", "accuracy"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=TOL["float32"], abs=1e-7), k
    assert set(got) == set(want)
    held = [n for n in got if n.startswith("encoder.") or n.endswith(".gate")]
    assert held and all(float(got[n].abs().max()) > 0 for n in held)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, g in got.items():
        if name.endswith(".bk"):
            assert max(float(g.abs().max()), float(want[name].abs().max())) <= 1e-6 * top, name
        else:
            close(g, want[name].numpy(), TOL["float32"])


# ------------------------------------------------------------ conversions


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_caches_convert_to_repros_trees(arch):
    """``params_from_jax`` names every parameter of the port's model, the
    encoder's split per layer and the gates as 0-d tensors;
    ``caches_to_numpy`` of the port's prefill caches has ``repro``'s
    layout, the ``cross`` ck/cv stacked (count, B, M, KV, dh)."""
    jm, params, tm = both(arch, seed=11, nonzero=True)
    sd = convert.params_from_jax(tm.cfg, params)
    assert set(sd) == set(tm.state_dict())
    assert all(sd[k].shape == v.shape for k, v in tm.state_dict().items())
    if tm.cfg.encoder_segments:
        assert len(tm.encoder.layers) == tm.cfg.encoder_layers
        np.testing.assert_array_equal(
            sd["encoder.layers.0.mix.bq"].numpy(),
            np.asarray(params["encoder"]["segments"][0][0]["mix"]["bq"][0]))
    else:
        assert sd["layers.3.cross.gate"].shape == ()
        assert float(sd["layers.3.cross.gate"]) == float(
            params["segments"][0][3]["cross"]["gate"][0]) != 0.0
    batch = {"tokens": tokens(tm.cfg, 2, 10, 11), **memory_inputs(tm.cfg, 2, 11, 24)}
    _, jcaches = jengine.make_prefill(jm)(params, as_jax(batch))
    _, caches = engine.make_prefill(tm)(as_torch(batch))
    got = convert.caches_to_numpy(tm.cfg, caches)
    ref = jax.tree.map(np.asarray, jcaches)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    M = 24 if tm.cfg.encoder_segments else tm.cfg.n_vision_tokens
    for g_seg, r_seg, (period, count) in zip(got, ref, tm.cfg.segments, strict=True):
        for g, r, spec in zip(g_seg, r_seg, period, strict=True):
            assert ("cross" in g) == spec.cross
            for part in g:
                for name in g[part]:
                    close(g[part][name], r[part][name], TOL["float32"])
            if spec.cross:
                assert g["cross"]["ck"].shape == (count, 2, M, tm.cfg.n_kv_heads,
                                                  tm.cfg.head_dim)


def test_vlm_flash_prefill_at_8192_matches_repro(monkeypatch):
    """S = 8192 with flash_attention=True: the port's self-attention layers
    run the flash kernel's twin on the CPU (``repro`` its pure-JAX pair
    schedule), the cross layer its unchunked ``_grouped_attn`` over the 16
    vision tokens. The logits, the cross cache and the value cache of the
    layer after the cross block are compared; the key caches carry rope at
    angles up to 8191 rad, whose float32 rounding differs between the two
    packages by about 1e-4 x max|k| from the first layer on, so no key
    cache is (``tests/test_torch_serve.py``'s flash case compares v too)."""
    jm, params, tm = both("llama-3.2-vision-11b", seed=12, nonzero=True, flash_attention=True)
    calls = []
    twin = flash.flash_attention_twin

    def counting_twin(*args, **kwargs):
        calls.append(args[0].shape)
        return twin(*args, **kwargs)

    monkeypatch.setattr(flash, "flash_attention_twin", counting_twin)
    batch = {"tokens": tokens(tm.cfg, 1, 8192, 12), **memory_inputs(tm.cfg, 1, 12)}
    jlg, jcaches = jax.jit(jengine.make_prefill(jm))(params, as_jax(batch))
    launches = flash.flash_attention.launches
    lg, caches = engine.make_prefill(tm)(as_torch(batch))
    assert calls == [(1, 8192, tm.cfg.n_heads, tm.cfg.head_dim)] * tm.cfg.n_layers
    assert flash.flash_attention.launches == launches  # no kernel on the CPU
    close(lg, jlg, TOL["float32"])
    got = convert.caches_to_numpy(tm.cfg, caches)
    close(got[0][3]["cross"]["cv"], jcaches[0][3]["cross"]["cv"], TOL["float32"])
    close(got[0][4]["mix"]["v"], jcaches[0][4]["mix"]["v"], TOL["float32"])


# ------------------------------------------------------------ batching


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_refuses_models_with_memory(arch):
    """The port's batcher refuses both with an AssertionError that points
    at ``serve.engine``; ``repro``'s cannot serve them either: whisper stops
    at its rope assertion, the VLM's prefill reads no ``vision``."""
    jm, params, tm = both(arch, seed=13)
    with pytest.raises(AssertionError, match="serve.engine"):
        batching.ContinuousBatcher(tm, 2, 32)
    req = jbatching.Request(0, tokens(tm.cfg, 1, 8, 13)[0], 4)
    if tm.cfg.encoder_segments:
        with pytest.raises(AssertionError, match="serve.engine"):
            jbatching.ContinuousBatcher(jm, params, 2, 32)
    else:
        with pytest.raises(KeyError, match="vision"):
            jbatching.ContinuousBatcher(jm, params, 2, 32).run([req])
