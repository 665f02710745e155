"""The port's model tier against ``repro`` on the CPU: layers, GQA
attention (prefill, chunked, flash and decode branches), the block loop
and ``Model.forward``, on the same numpy inputs and the same weights
(``convert.params_from_jax``). float32 comparisons are tight (the two
differ only by the order of accumulation); bfloat16 ones allow the
5e-2 x max|logit| of ``tests/test_serve.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.configs.registry import smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro_torch import convert
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.models import attention, layers
from repro_torch.models.model import Model
from torch_parity import BF16_TIE, router_margins


@pytest.fixture(autouse=True)
def _no_grad():
    """Parameters require grad (the port trains): every case here compares
    forward passes, so it runs under ``torch.no_grad()``, as serving does."""
    with torch.no_grad():
        yield


RNG = np.random.default_rng(11)
DENSE = ["qwen3-4b", "qwen2.5-32b", "starcoder2-7b"]


def cfgs(arch, dtype="float32", **kw):
    """The same smoke config from both packages."""
    return (dataclasses.replace(jsmoke(arch), dtype=dtype, **kw),
            dataclasses.replace(smoke_config(arch), dtype=dtype, **kw))


def both_models(arch, dtype="float32", seed=1, **kw):
    jc, tc = cfgs(arch, dtype, **kw)
    jm = JModel(jc)
    params = jm.init(jax.random.key(seed))
    tm = Model(tc, device="cpu")
    tm.load_state_dict(convert.params_from_jax(tc, params))
    return jm, params, tm


def f32(a) -> np.ndarray:
    """An array as float32; the port's bfloat16 arrives as uint16 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def close(got, want, rel):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, scale)


def tt(a) -> torch.Tensor:
    return convert.to_tensor(np.asarray(a), "cpu")


TOL = {"float32": 1e-4, "bfloat16": 5e-2}


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(norm, dtype):
    jc, tc = cfgs("qwen3-4b", dtype, norm=norm)
    x = RNG.standard_normal((2, 5, 64)).astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    p = layers.Norm(tc, 64, "cpu")
    p.scale.copy_(torch.from_numpy(RNG.uniform(0.5, 1.5, 64).astype(np.float32)))
    if p.bias is not None:
        p.bias.copy_(torch.from_numpy(RNG.standard_normal(64).astype(np.float32)))
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.state_dict().items()}
    close(convert.to_numpy(layers.apply_norm(tt(x), p, tc)),
          jlayers.apply_norm(jnp.asarray(x), jp, jc), TOL[dtype] / 10)
    close(convert.to_numpy(layers.rms_norm_simple(tt(x), p.scale, 1e-5)),
          jlayers.rms_norm_simple(jnp.asarray(x), jp["scale"], 1e-5), TOL[dtype] / 10)


@pytest.mark.parametrize("batched", [False, True])
def test_rope_and_sinusoidal_match(batched):
    pos = RNG.integers(0, 5000, (2, 7) if batched else (7,)).astype(np.int32)
    x = RNG.standard_normal((2, 7, 3, 16)).astype(ml_dtypes.bfloat16)
    jcos, jsin = jlayers.rope_table(jnp.asarray(pos), 16, 1e6)
    cos, sin = layers.rope_table(torch.from_numpy(pos), 16, 1e6)
    close(cos.numpy(), jcos, 1e-5)
    close(sin.numpy(), jsin, 1e-5)
    got = layers.apply_rope(tt(x), cos, sin)
    assert got.dtype == torch.bfloat16
    close(convert.to_numpy(got), jlayers.apply_rope(jnp.asarray(x), jcos, jsin), 1e-2)
    flat = pos.reshape(-1)
    close(layers.sinusoidal_embed(torch.from_numpy(flat), 32).numpy(),
          jlayers.sinusoidal_embed(jnp.asarray(flat), 32), 1e-5)


@pytest.mark.parametrize("arch", DENSE)  # gated silu; gated + bias-free; ungated gelu + bias
def test_mlp_and_embedding_match(arch):
    jc, tc = cfgs(arch)
    jp = jlayers.init_mlp(jax.random.key(3), jc, 64, 128)
    jp = {k: v + 0.1 if k in ("bi", "bo") else v for k, v in jp.items()}  # nonzero biases
    p = layers.MLP(tc, 64, 128, None, "meta").to_empty(device="cpu")
    p.load_state_dict({k: tt(v) for k, v in jp.items()})
    x = RNG.standard_normal((2, 5, 64)).astype(np.float32)
    close(layers.apply_mlp(tt(x), p, tc).numpy(), jlayers.apply_mlp(jnp.asarray(x), jp, jc), 1e-5)

    je = jlayers.init_embed(jax.random.key(4), jc, 512)
    e = layers.Embed(tc, 512, None, "meta").to_empty(device="cpu")
    e.load_state_dict({"table": tt(je["table"])})
    ids = RNG.integers(0, 512, (2, 9)).astype(np.int32)
    close(layers.embed_tokens(torch.from_numpy(ids), e).numpy(),
          jlayers.embed_tokens(jnp.asarray(ids), je), 0)


def test_init_draws_the_same_distribution():
    """Not the same bits (the generators differ): the same shapes, dtypes,
    constants and scales."""
    jm, params, _ = both_models("qwen3-4b", "bfloat16")
    tm = Model(smoke_config("qwen3-4b"), device="cpu", seed=5)
    ref = convert.params_from_jax(tm.cfg, params)
    got = tm.state_dict()
    assert sorted(got) == sorted(ref)
    for name, t in got.items():
        assert t.shape == ref[name].shape and t.dtype == ref[name].dtype, name
        a, b = t.float(), ref[name].float()
        if b.std() == 0:
            assert torch.equal(a, b), name
        else:
            assert abs(float(a.std() / b.std()) - 1) < 0.1, name


# --------------------------------------------------------------- attention


def _attn_inputs(arch, dtype, S):
    jc, tc = cfgs(arch, dtype)
    jp = jattn.init_attention(jax.random.key(5), jc, None)
    if jc.attn_bias:
        jp = {k: v + 0.05 if k in ("bq", "bk", "bv") else v for k, v in jp.items()}
    p = attention.Attention(tc, None, "meta").to_empty(device="cpu")
    p.load_state_dict({k: tt(v) for k, v in jp.items()})
    npd = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    x = RNG.standard_normal((2, S, 64)).astype(npd)
    return jc, tc, jp, p, x


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-32b"])  # qk-norm; QKV bias
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_prefill_then_decode_match(arch, dtype):
    jc, tc, jp, p, x = _attn_inputs(arch, dtype, 13)
    S = 12
    jcache = jattn.init_gqa_cache(jc, None, 2, S)
    jout, jc1 = jattn.gqa_forward(jnp.asarray(x[:, :S]), jp, jc, None, cache=jcache)
    out, c1 = attention.gqa_forward(tt(x[:, :S]), p, tc, cache=attention.init_gqa_cache(tc, 2, S))
    close(convert.to_numpy(out), jout, TOL[dtype] / 5)
    for name in ("k", "v"):
        close(convert.to_numpy(c1[name]), jc1[name], TOL[dtype] / 5)

    # decode position S against a cache of S + 3
    pad = lambda a: jnp.pad(a, ((0, 0), (0, 3), (0, 0), (0, 0)))
    jc2 = {n: pad(jc1[n]) for n in ("k", "v")}
    c2 = {n: torch.nn.functional.pad(c1[n], (0, 0, 0, 0, 0, 3)) for n in ("k", "v")}
    jout, jc3 = jattn.gqa_forward(jnp.asarray(x[:, S:]), jp, jc, None, cache=jc2, decode=True,
                                  positions=jnp.asarray([S], jnp.int32))
    out, c3 = attention.gqa_forward(tt(x[:, S:]), p, tc, cache=c2, decode=True,
                                    positions=torch.tensor([S]))
    close(convert.to_numpy(out), jout, TOL[dtype] / 5)
    assert c3["k"] is c2["k"]  # decode writes the cache in place
    for name in ("k", "v"):
        close(convert.to_numpy(c3[name]), jc3[name], TOL[dtype] / 5)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_and_train_flash_attention_match(causal):
    """The chunked branch (S > Q_CHUNK) and the forward of the training
    flash path, on (B, S, H, dh) = (1, 1024, 4, 16), KV 2."""
    q, k, v = (RNG.standard_normal((1, 1024, h, 16)).astype(np.float32) for h in (4, 2, 2))
    pos = np.arange(1024, dtype=np.int32)
    want = jattn._chunked_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                               causal=causal, window=0, q_positions=jnp.asarray(pos),
                               k_positions=jnp.asarray(pos), scale=0.25)
    got = attention._chunked_attn(tt(q), tt(k), tt(v), causal=causal,
                                  q_positions=torch.arange(1024), k_positions=torch.arange(1024),
                                  scale=0.25)
    close(got.numpy(), want, 1e-5)
    want = jattn._flash_attn_train(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, scale=0.25)
    got = attention._flash_attn_train(tt(q), tt(k), tt(v), causal=causal, scale=0.25)
    close(got.numpy(), want, 1e-5)
    assert attention._pick_chunks(2, 32, 8192, 8192) == jattn._pick_chunks(2, 32, 8192, 8192)


# ------------------------------------------------------------------- model


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match(arch, dtype):
    jm, params, tm = both_models(arch, dtype)
    toks = RNG.integers(0, jm.cfg.vocab, (2, 24)).astype(np.int32)
    want, _, jaux = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got, caches, aux = tm({"tokens": torch.from_numpy(toks)})
    assert caches is None and float(aux) == float(jaux) == 0.0
    assert got.shape == want.shape == (2, 24, tm.vocab_padded)
    close(convert.to_numpy(got), want, TOL[dtype])


@pytest.mark.parametrize("pos_embedding", ["learned", "sinusoidal", "none"])
def test_forward_with_other_position_embeddings_matches(pos_embedding):
    jm, params, tm = both_models("qwen3-4b", pos_embedding=pos_embedding, tie_embeddings=False)
    toks = RNG.integers(0, jm.cfg.vocab, (2, 16)).astype(np.int32)
    want, _, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    close(tm({"tokens": torch.from_numpy(toks)})[0].numpy(), want, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_logits_match(dtype, monkeypatch):
    """deepseek-moe-16b's smoke config (a dense layer, then an MoE layer
    with a shared expert): logits and the router's aux loss. ``repro``'s
    model sorts with ``lax.sort``, the port's with the kernels' twins. In
    bfloat16 the tokens whose top-k margin is within bf16's precision
    (``torch_parity.BF16_TIE``; at most one in ten) may route elsewhere
    and are left out."""
    jm, params, tm = both_models("deepseek-moe-16b", dtype)
    toks = np.random.default_rng(12).integers(0, jm.cfg.vocab, (2, 24)).astype(np.int32)
    want, _, jaux = jm.forward(params, {"tokens": jnp.asarray(toks)})
    margins = router_margins(monkeypatch)
    got, _, aux = tm({"tokens": torch.from_numpy(toks)})
    keep = np.ones((2, 24), bool)
    if dtype == "bfloat16":
        keep = (margins[0] >= BF16_TIE).numpy().reshape(2, 24)
        assert keep.mean() >= 0.9
    close(convert.to_numpy(got)[keep], np.asarray(want)[keep], TOL[dtype])
    assert abs(float(aux) - float(jaux)) <= TOL[dtype] * float(jaux)


def test_moe_block_sort_paths_agree_and_ep_decode_raises():
    """An MoE block with ``use_pallas_moe`` True and False gives the same
    bits. ``decode_moe_ep`` (repro's EP x TP decode), which raised here
    until item 10.4.1 was ported, takes ``repro``'s test: without a 2-D
    expert mesh the block decodes through ``moe_forward_decode`` whatever
    the flag says, and equals ``repro``'s block with the flag set (output
    and cache within 1e-4 x max), and the flag changes no bit of it."""
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as tfm

    jm, params, tm = both_models("deepseek-moe-16b", seed=3)
    tc = tm.cfg
    spec = tc.layer_list()[1]
    assert spec.ffn == "moe" and tm.layers[1].shared is not None
    x = torch.from_numpy(RNG.standard_normal((2, 16, 64)).astype(np.float32))
    pos = torch.arange(16)
    a = tfm.apply_block(x, tm.layers[1], spec, tc, positions=pos, use_pallas_moe=True)
    b = tfm.apply_block(x, tm.layers[1], spec, tc, positions=pos, use_pallas_moe=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2]) and float(a[2]) > 0
    ep = dataclasses.replace(tc, decode_moe_ep=True)
    jep = dataclasses.replace(jm.cfg, decode_moe_ep=True)
    x1 = x[:, 3:4]
    outs = []
    for c in (ep, tc):
        cache = tfm.init_block_cache(spec, c, 2, 4)
        outs.append(tfm.apply_block(x1, tm.layers[1], spec, c, positions=torch.tensor([2]),
                                    cache=cache, decode=True))
    (got, got_cache, _), (plain, _, _) = outs
    assert torch.equal(got, plain)
    jp = jax.tree.map(lambda t: t[0], params["segments"][1][0])  # the MoE layer's leaves
    jcache = jtfm.init_block_cache(spec, jep, None, 2, 4)
    want, want_cache, _ = jtfm.apply_block(jnp.asarray(x1.numpy()), jp, spec, jep, None,
                                           positions=jnp.asarray([2], jnp.int32), cache=jcache,
                                           decode=True)
    close(convert.to_numpy(got), np.asarray(want), TOL["float32"])
    for name in ("k", "v"):
        close(convert.to_numpy(got_cache["mix"][name]), np.asarray(want_cache["mix"][name]),
              TOL["float32"])


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-32b", "starcoder2-7b", "starcoder2-15b",
                                  "deepseek-moe-16b", "deepseek-v3-671b", "falcon-mamba-7b",
                                  "recurrentgemma-9b", "whisper-base", "llama-3.2-vision-11b"])
def test_param_count_matches_repro_at_full_width(arch):
    """Counted on the meta device: no allocation at full width."""
    assert get_config(arch).param_count() == jget_config(arch).param_count()
    assert get_config(arch).active_param_count() == jget_config(arch).active_param_count()


def test_configs_are_copies():
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))
        assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(jsmoke(arch))


@pytest.mark.parametrize("arch,item", [
    ("recurrentgemma-9b", "item 10.6"), ("falcon-mamba-7b", "item 10.6"),
    ("whisper-base", "item 10.3"), ("llama-3.2-vision-11b", "item 10.3"),
])
def test_unported_architectures_raise_naming_their_item(arch, item):
    """Both items are ported, and each model builds. The recurrent ones
    (item 10.6): each block's mixer is the module of its spec, and a Mamba
    block (ffn "none") has no ln2. The cross-attention ones (item 10.3):
    each cross block holds ``ln_x`` and a cross ``Attention``, with a
    ``gate`` on the VLM only; whisper holds its encoder's layers."""
    from repro_torch.models import recurrent

    cfg = smoke_config(arch)
    tm = Model(cfg, device="cpu")
    kinds = {"rglru": recurrent.RGLRU, "mamba": recurrent.Mamba,
             "local_attn": attention.Attention, "attn": attention.Attention}
    for block, spec in zip(tm.layers, cfg.layer_list(), strict=True):
        assert type(block.mix) is kinds[spec.mixer]
        assert hasattr(block, "ln2") == (spec.ffn != "none")
        assert hasattr(block, "ln_x") == hasattr(block, "cross") == spec.cross
        if spec.cross:
            assert type(block.cross) is attention.Attention
            assert (block.cross.gate is not None) == (arch == "llama-3.2-vision-11b")
    assert any(s.cross for s in cfg.layer_list()) == (item == "item 10.3")
    if arch == "whisper-base":
        full = Model(get_config(arch), device="meta")
        assert len(full.encoder.layers) == 6 and len(tm.encoder.layers) == 1
    else:
        assert tm.encoder is None


def test_unported_attention_branches_raise_naming_their_item():
    _, tc, _, p, x = _attn_inputs("qwen3-4b", "float32", 4)
    x = tt(x)
    # sliding windows (item 10.2) are ported: a window of the whole prompt
    # is plain causal attention
    out, _ = attention.gqa_forward(x, p, tc, window=x.shape[1])
    want, _ = attention.gqa_forward(x, p, tc)
    assert torch.equal(out, want)
    # cross-attention (item 10.3) is ported: it runs over the memory
    out, _ = attention.gqa_forward(x, p, tc, memory=x[:, :3])
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    # per-slot decode positions (item 10.1) are ported: they run
    out, cache = attention.gqa_forward(x[:, :1], p, tc, decode=True,
                                       positions=torch.tensor([3, 4]),
                                       cache=attention.init_gqa_cache(tc, 2, 8))
    assert out.shape == (2, 1, tc.d_model) and bool(torch.isfinite(out).all())
    assert cache["k"][0, 3].abs().sum() > 0 and cache["k"][1, 4].abs().sum() > 0
    ring = attention.init_gqa_cache(tc, 2, 8, window=4)
    assert ring["k"].shape == (2, 4, tc.n_kv_heads, tc.head_dim)
    assert ring["pos"].tolist() == [-1] * 4
    tm = Model(tc, device="cpu")
    logits, _, _ = tm({"tokens": torch.zeros((2, 1), dtype=torch.int32)},
                      caches=tm.init_caches(2, 4), decode=True, pos=torch.tensor([1, 2]))
    assert logits.shape == (2, 1, tm.vocab_padded)


def test_model_follows_the_device_rule():
    if torch.cuda.is_available():
        pytest.skip("the rule's failure case needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(smoke_config("qwen3-4b"))
