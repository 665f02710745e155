"""The port's recurrent mixers (``models/recurrent.py``: the chunked scan,
the causal conv, RG-LRU and Mamba) against ``repro`` on the CPU, and the
falcon-mamba-7b smoke model end to end: prefill, greedy generation and
one train step's loss and gradients, on the same numpy inputs and the
same weights (``convert.params_from_jax``).

Tolerance: float32 within 1e-5 x the reference's largest magnitude. The
scans associate their products in other orders (a log-depth Hillis-Steele
scan here, ``jax.lax.associative_scan`` in ``repro``), which is the only
expected difference. The conv is held bit for bit in bfloat16 (``repro``
eager, op by op). ``repro``'s other functions run compiled (``jax.jit``):
its eager scan dispatches hundreds of small programs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jrec
from repro.models.model import Model as JModel
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models import recurrent
from repro_torch.models.model import Model
from torch_model_parity import TOL, cfgs, close, f32, generate_both, loss_and_grads_both

ARCH = "falcon-mamba-7b"
MIXERS = {"rglru": ("recurrentgemma-9b", jrec.init_rglru, jrec.rglru_forward,
                    jrec.init_rglru_cache, recurrent.RGLRU, recurrent.rglru_forward,
                    recurrent.init_rglru_cache),
          "mamba": ("falcon-mamba-7b", jrec.init_mamba, jrec.mamba_forward,
                    jrec.init_mamba_cache, recurrent.Mamba, recurrent.mamba_forward,
                    recurrent.init_mamba_cache)}


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def tt(a) -> torch.Tensor:
    return convert.to_tensor(np.asarray(a), "cpu")


def tree_close(got: dict, want: dict, rel=TOL):
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], rel)


# ------------------------------------------------------------------- scan


@pytest.mark.parametrize("rest", [(16,), (12, 8)], ids=["B-S-w", "B-S-di-N"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("S", [256, 1024])
def test_chunked_linear_scan_matches_repro(S, with_h0, rest):
    """One chunk (S = 256) and four (S = 1024), from zero or from h0, on
    RG-LRU's (B, S, w) and Mamba's (B, S, di, N) shapes; a close to 1, so
    that h carries far."""
    rng = np.random.default_rng(S + 7 * len(rest) + with_h0)
    a = rng.uniform(0.9, 1.0, (2, S) + rest).astype(np.float32)
    b = rng.standard_normal((2, S) + rest).astype(np.float32)
    h0 = rng.standard_normal((2,) + rest).astype(np.float32) if with_h0 else None
    jh, jl = jax.jit(jrec._chunked_linear_scan)(jnp.asarray(a), jnp.asarray(b),
                                                None if h0 is None else jnp.asarray(h0))
    th, tl = recurrent._chunked_linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                                            None if h0 is None else torch.from_numpy(h0))
    close(th, jh)
    close(tl, jl)
    assert torch.equal(tl, th[:, -1])


@pytest.mark.parametrize("S", [1, 3, 100, 255])
def test_assoc_scan_equals_the_step_by_step_recurrence(S):
    """Lengths that are no power of two, against the loop h_t = a_t h_{t-1}
    + b_t in float64."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 5))
    b = rng.standard_normal((2, S, 5))
    h0 = rng.standard_normal((2, 5))
    h, want = h0, []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got, last = recurrent._assoc_scan(torch.from_numpy(a), torch.from_numpy(b),
                                      torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(last.numpy(), got[:, -1].numpy())


def test_scan_refuses_a_ragged_long_sequence_as_repro():
    """Past one chunk the sequence must be a multiple of SCAN_CHUNK: both
    packages raise AssertionError."""
    assert recurrent.SCAN_CHUNK == jrec.SCAN_CHUNK == 256
    a = np.ones((1, 300, 2), np.float32)
    with pytest.raises(AssertionError):
        jrec._chunked_linear_scan(jnp.asarray(a), jnp.asarray(a), None)
    with pytest.raises(AssertionError, match="300"):
        recurrent._chunked_linear_scan(torch.from_numpy(a), torch.from_numpy(a), None)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_repro_bit_for_bit(with_state):
    """bfloat16, the taps summed left to right in bfloat16 on both sides."""
    rng = np.random.default_rng(11 + with_state)
    x = jnp.asarray(rng.standard_normal((2, 40, 24)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((4, 24)) * 0.5, jnp.bfloat16)
    state = jnp.asarray(rng.standard_normal((2, 3, 24)), jnp.bfloat16) if with_state else None
    jy, js = jrec._causal_conv(x, w, state)
    ty, ts = recurrent._causal_conv(tt(x), tt(w), None if state is None else tt(state))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(ty), f32(jy))
    np.testing.assert_array_equal(f32(ts), f32(js))


# ----------------------------------------------------------------- mixers


def mixer_pair(mixer, dtype="float32", seed=4):
    """``repro``'s parameters of one mixer and the port's module holding
    them."""
    arch, jinit, _, _, cls, _, _ = MIXERS[mixer]
    jc, tc = cfgs(arch, dtype)
    jp = jax.jit(functools.partial(jinit, cfg=jc, axes=None))(jax.random.key(seed))
    p = cls(tc, None, "meta").to_empty(device="cpu")
    p.load_state_dict({k: tt(v) for k, v in jp.items()})
    return jc, tc, jp, p


@pytest.mark.parametrize("S", [40, 512])
@pytest.mark.parametrize("mixer", ["rglru", "mamba"])
def test_mixer_prefill_and_decode_match_repro(mixer, S):
    """Prefill from the zeroed cache (one scan chunk at S = 40, two at 512)
    and its cache, then three decode steps from that cache: outputs and
    caches."""
    _, _, jfwd, jcache, _, tfwd, tcache = MIXERS[mixer]
    jc, tc, jp, p = mixer_pair(mixer)
    jfwd = jax.jit(functools.partial(jfwd, cfg=jc, axes=None), static_argnames="decode")
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S + 3, tc.d_model)).astype(np.float32)
    jo, jcc = jfwd(jnp.asarray(x[:, :S]), jp, cache=jcache(jc, None, 2))
    to, tcc = tfwd(torch.from_numpy(x[:, :S]), p, tc, cache=tcache(tc, 2))
    close(to, jo)
    tree_close(tcc, jcc)
    for i in range(S, S + 3):
        jo, jcc = jfwd(jnp.asarray(x[:, i:i + 1]), jp, cache=jcc, decode=True)
        to, tcc = tfwd(torch.from_numpy(x[:, i:i + 1]), p, tc, cache=tcc, decode=True)
        close(to, jo)
        tree_close(tcc, jcc)


@pytest.mark.parametrize("mixer", ["rglru", "mamba"])
def test_mixer_without_a_cache_matches_repro(mixer):
    """The training path: no cache in, none out."""
    _, _, jfwd, _, _, tfwd, _ = MIXERS[mixer]
    jc, tc, jp, p = mixer_pair(mixer, seed=6)
    x = np.random.default_rng(6).standard_normal((2, 24, tc.d_model)).astype(np.float32)
    jo, jcc = jax.jit(functools.partial(jfwd, cfg=jc, axes=None))(jnp.asarray(x), jp)
    to, tcc = tfwd(torch.from_numpy(x), p, tc)
    assert jcc is None and tcc is None
    close(to, jo)


@pytest.mark.parametrize("mixer", ["rglru", "mamba"])
def test_recurrent_caches_match_repros_shapes(mixer):
    _, _, _, jcache, _, _, tcache = MIXERS[mixer]
    jc, tc = cfgs(MIXERS[mixer][0], "bfloat16")
    want = jcache(jc, None, 3)
    got = tcache(tc, 3)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in got.items()} == {
        k: (v.shape, "torch." + str(v.dtype)) for k, v in want.items()}
    assert all(float(v.abs().sum()) == 0 for v in got.values())


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_params_from_jax_round_trips_every_leaf(arch):
    """Every RG-LRU and Mamba leaf of ``repro``'s model lands under its
    name in the port's (bf16 bits unchanged, float32 ``lam``, ``dt_bias``,
    ``A_log`` and ``D``); the names are the modules' own."""
    jc, tc = cfgs(arch, "bfloat16")
    params = jax.jit(JModel(jc).init)(jax.random.key(2))
    tm = Model(tc, device="cpu")
    sd = convert.params_from_jax(tc, params)
    assert {k: (tuple(v.shape), v.dtype) for k, v in sd.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in tm.state_dict().items()}
    tm.load_state_dict(sd)
    mixer_leaves = 0
    layer = 0
    for (period, count), seg in zip(jc.segments, params["segments"], strict=True):
        for c in range(count):
            for i, spec in enumerate(period):
                mix = getattr(tm.layers[layer], "mix")
                if spec.mixer in ("rglru", "mamba"):
                    for name, leaf in seg[i]["mix"].items():
                        np.testing.assert_array_equal(
                            convert.to_numpy(getattr(mix, name).detach()),
                            convert.to_numpy(tt(np.asarray(leaf[c]))))
                        mixer_leaves += 1
                layer += 1
    assert mixer_leaves == sum(
        {"rglru": 7, "mamba": 8}.get(s.mixer, 0) for s in tc.layer_list())


def test_recurrent_init_follows_repro():
    """Seeded weights: ``lam`` 2.0, ``A_log`` log(1..N) on every row,
    ``D`` ones, ``dt_bias`` zeros, and each projection's std at its fan-in
    ** -0.5 (the conv at 0.1), within 5% at the full model's widths."""
    gen = torch.Generator().manual_seed(0)
    tc = dataclasses.replace(smoke_config("falcon-mamba-7b"), d_model=256, ssm_state=16)
    m = recurrent.Mamba(tc, gen, "cpu")
    di, N = 512, 16
    assert torch.equal(m.A_log, torch.log(torch.arange(1, N + 1.0)).expand(di, N))
    assert torch.equal(m.D, torch.ones(di)) and torch.equal(m.dt_bias, torch.zeros(di))
    assert m.A_log.dtype == m.D.dtype == m.dt_bias.dtype == torch.float32
    for name, scale in (("in_proj", 256 ** -0.5), ("x_proj", di ** -0.5),
                        ("dt_proj", 16 ** -0.5), ("out_proj", di ** -0.5), ("conv", 0.1)):
        std = float(getattr(m, name).float().std())
        assert abs(std / scale - 1) < 0.05, (name, std)
    tc = dataclasses.replace(smoke_config("recurrentgemma-9b"), d_model=256, lru_width=256)
    r = recurrent.RGLRU(tc, gen, "cpu")
    assert torch.equal(r.lam, torch.full((256,), 2.0)) and r.lam.dtype == torch.float32
    assert tuple(r.wa.shape) == (tc.n_heads, 256 // tc.n_heads, 256 // tc.n_heads)
    for name, scale in (("wx", 256 ** -0.5), ("wg", 256 ** -0.5), ("wo", 256 ** -0.5),
                        ("wa", 64 ** -0.5), ("conv", 0.1)):
        std = float(getattr(r, name).float().std())
        assert abs(std / scale - 1) < 0.05, (name, std)


# ------------------------------------------------------------ whole model


@pytest.fixture(scope="module")
def mamba_generated():
    """falcon-mamba's smoke model: 2 prompts of 512 tokens (two scan
    chunks), 24 new."""
    return generate_both(ARCH, 512, 24)


def test_falcon_mamba_generates_repros_tokens(mamba_generated):
    (want, _), (got, _) = mamba_generated
    assert got.dtype == np.int32 and got.shape == (2, 24)
    np.testing.assert_array_equal(got, want)


def test_falcon_mamba_prefill_and_decode_logits_match_repro(mamba_generated):
    (_, jlogs), (_, tlogs) = mamba_generated
    assert len(jlogs) == len(tlogs) == 24
    for got, want in zip(tlogs, jlogs, strict=True):
        close(got, want)


def test_falcon_mamba_loss_and_gradients_match_jax_grad():
    """S = 512: two scan chunks, differentiated through the chunk loop.
    Each leaf's gradient within TOL x its largest |value| in ``repro``."""
    (jl, jmet, want), (tl, tmet, got) = loss_and_grads_both(ARCH)
    assert tl == pytest.approx(jl, rel=TOL)
    for k in ("nll", "zloss", "accuracy"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=TOL, abs=1e-7), k
    assert set(got) == set(want)
    for name, g in got.items():
        close(g, want[name].numpy())
        assert float(g.abs().sum()) > 0, name
