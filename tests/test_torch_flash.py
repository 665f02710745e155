"""The port's flash attention on the CPU: its plain twin against ``repro``'s
Pallas kernel (interpret mode) and against the attention oracles, and the
wrapper's contract. The CUDA kernel itself is held against the twin on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash import flash_attention as pallas_flash
from repro.models import attention as jattn
from repro_torch.kernels import build, flash, ref

RNG = np.random.default_rng(7)


def _mk(B, S, H, KV, dh, dtype=np.float32, T=None, rng=RNG):
    T = S if T is None else T
    return (rng.standard_normal((B, S, H, dh)).astype(dtype),
            rng.standard_normal((B, T, KV, dh)).astype(dtype),
            rng.standard_normal((B, T, KV, dh)).astype(dtype))


def _t(a):
    return torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16 if a.dtype == ml_dtypes.bfloat16 else torch.float32)


@pytest.mark.parametrize("B,S,H,KV,dh", [
    (1, 256, 2, 2, 32),    # MHA
    (1, 512, 4, 2, 64),    # GQA rep=2
    (2, 512, 4, 1, 32),    # MQA
    (1, 1024, 2, 2, 128),  # 128-wide heads
])
@pytest.mark.parametrize("causal", [True, False])
def test_twin_matches_pallas_kernel(B, S, H, KV, dh, causal):
    q, k, v = _mk(B, S, H, KV, dh)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                        bq=128, bk=128)
    got = flash.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_twin_matches_pallas_kernel_bf16():
    q, k, v = _mk(1, 512, 2, 2, 64, ml_dtypes.bfloat16)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                        bq=128, bk=256)
    got = flash.flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 3e-5), (ml_dtypes.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H", [(1, 1024, 4), (2, 512, 2)])
def test_twin_at_mla_widths_matches_repro_pairs(B, S, H, dtype, tol, causal):
    """MLA's (dqk, dv) = (192, 128), heads not grouped (H = KV): the
    wrapper on the CPU (the twin) against ``repro``'s ``_flash_attn_pairs``,
    what ``repro``'s MLA prefill runs off the TPU (its Pallas kernel takes
    one width). In bf16 ``repro`` rounds p to bf16 and the twin keeps it in
    float32: 2e-2, the bf16 test's tolerance above."""
    rng = np.random.default_rng(192 + S)
    q, k = (rng.standard_normal((B, S, H, 192)).astype(dtype) for _ in range(2))
    v = rng.standard_normal((B, S, H, 128)).astype(dtype)
    scale = 192 ** -0.5
    want = jattn._flash_attn_pairs(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, scale=scale)
    got = flash.flash_attention(_t(q), _t(k), _t(v), causal=causal, scale=scale)
    assert got.shape == (B, S, H, 128) and got.dtype == _t(v).dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    kt = flash.kernel_twin(_t(q), _t(k), _t(v), causal=causal, scale=scale)
    assert kt.shape == got.shape
    np.testing.assert_allclose(kt.float().numpy(), got.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,bq,bk", [(1000, 256, 512), (333, 64, 128), (7, 256, 512)])
def test_twin_at_ragged_lengths_matches_oracle(S, bq, bk, causal):
    """S not a multiple of the tiles: the twin (and the kernel) need no
    divisibility, which the Pallas kernel asserts."""
    q, k, v = (_t(a) for a in _mk(2, S, 4, 1, 64))
    want = ref.attention_ref(q, k, v, causal=causal)
    got = flash.flash_attention_twin(q, k, v, causal=causal, bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_twin_rounds_p_where_the_kernel_does(causal):
    """kernel_twin is the twin at the key tile width of the route the shape
    takes (mma.sync at dh 32, wgmma at dh 128) with p rounded to bf16 before
    PV; the query tile width changes no value, and the rounding of p is the
    only thing that sets it apart from the twin. The dh-128 inputs come from
    a generator of their own, so the later tests draw what they drew before."""
    for dh, rng in ((32, RNG), (128, np.random.default_rng(128))):
        q, k, v = (_t(a) for a in _mk(1, 300, 4, 2, dh, ml_dtypes.bfloat16, rng=rng))
        bk = flash.KERNEL_BK[(torch.bfloat16, dh, dh)]
        got = flash.kernel_twin(q, k, v, causal=causal)
        assert torch.equal(got, flash.flash_attention_twin(
            q, k, v, causal=causal, bq=64, bk=bk, p_dtype=torch.bfloat16))
        f32 = flash.flash_attention_twin(q, k, v, causal=causal, bk=bk)
        assert not torch.equal(got, f32)
        np.testing.assert_allclose(got.float().numpy(), f32.float().numpy(),
                                   rtol=2e-2, atol=2e-2)
        qf, kf, vf = q.float(), k.float(), v.float()
        np.testing.assert_allclose(flash.kernel_twin(qf, kf, vf, causal=causal).numpy(),
                                   flash.flash_attention_twin(qf, kf, vf, causal=causal).numpy(),
                                   rtol=3e-5, atol=3e-5)


def test_kernel_bk_follows_flash_cu():
    """ROUTES and KERNEL_BK (the twin's key tiles) agree with the dispatch
    and the tile constants of csrc/flash.cu, so that the twin and the
    kernel cannot drift apart unnoticed."""
    src = (build.CSRC / "flash.cu").read_text()
    const = {name: int(val) for name, val in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    # each kernel walks its key tiles in steps of its own constant
    assert "key_tiles(q0, kWgBq, S, T, kWgBk, causal)" in src
    assert "key_tiles(q0, kBq, S, T, kBk, causal)" in src
    assert "key_tiles(q0, kFq, S, T, kFk, causal)" in src
    routes = {"launch_wgmma": ("wgmma", const["kWgBk"]), "launch_bf16": ("mma.sync", const["kBk"]),
              "launch_f32": ("fma", const["kFk"])}
    dtypes = {"0": torch.bfloat16, "1": torch.float32}
    lines = re.findall(r"ROUTE\((\d), (\d+), (\d+), (launch_\w+)\)", src)
    got = {(dtypes[dt], int(dqk), int(dv)): routes[fn] for dt, dqk, dv, fn in lines}
    assert len(got) == len(lines) == 2 * len(flash.HEAD_DIMS)
    assert got == {key: (route, flash.KERNEL_BK[key]) for key, route in flash.ROUTES.items()}
    assert {key[1:] for key in got} == set(flash.HEAD_DIMS)


def test_bf16_error_passes_one_ulp_and_fails_a_dropped_key_tile():
    """The card's bf16 limit: outputs one bf16 ulp off pass when they are
    few (a rounding on the other side of a midpoint) and fail on the mean
    when they are all; the same attention with one 64-key tile left out
    (keys 128..191) fails."""
    q, k, v = (_t(a) for a in _mk(1, 2048, 4, 2, 64, ml_dtypes.bfloat16))
    want = flash.kernel_twin(q, k, v, causal=False)
    same = flash.bf16_error(want, want)
    assert same["ok"] and same["limit_use"] == 0.0
    bits = want.view(torch.int16)
    up = torch.where(bits == 0, bits, bits + 1)
    every = torch.zeros_like(bits, dtype=torch.bool).view(-1)
    every[::64] = True
    few = flash.bf16_error(torch.where(every.view(bits.shape), up, bits).view(torch.bfloat16),
                           want)
    assert few["ok"] and 0.4 < few["limit_use"] <= 1.0, few
    everywhere = flash.bf16_error(up.view(torch.bfloat16), want)
    assert everywhere["limit_use"] <= 1.0 and not everywhere["ok"], everywhere
    keep = torch.cat([torch.arange(128), torch.arange(192, 2048)])
    dropped = flash.kernel_twin(q, k[:, keep], v[:, keep], causal=False)
    bad = flash.bf16_error(dropped, want)
    assert not bad["ok"] and bad["limit_use"] > 10, bad


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_repro(dtype, causal):
    q, k, v = _mk(2, 96, 4, 2, 16, dtype, T=96)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = ref.attention_ref(_t(q), _t(k), _t(v), causal=causal)
    tol = 3e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_wrapper_on_cpu_runs_the_twin_and_counts_no_launch():
    q, k, v = (_t(a) for a in _mk(1, 64, 4, 2, 16))
    before = flash.flash_attention.launches
    out = flash.flash_attention(q, k, v, causal=True, scale=0.3)
    assert flash.flash_attention.launches == before
    want = flash.flash_attention_twin(q, k, v, causal=True, scale=0.3)
    assert torch.equal(out, want)
    np.testing.assert_allclose(out.numpy(), ref.attention_ref(q, k, v, scale=0.3).numpy(),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("shapes,dtypes,exc,match", [
    (((1, 8, 4, 16), (1, 8, 3, 16), (1, 8, 3, 16)), None, ValueError, "multiple of KV"),
    (((1, 8, 4, 16), (1, 8, 2, 16), (1, 9, 2, 16)), None, ValueError, "want q"),
    (((1, 8, 4, 24), (1, 8, 2, 24), (1, 8, 2, 24)), None, ValueError, "head_dim 24"),
    (((1, 8, 4, 192), (1, 8, 2, 192), (1, 8, 2, 64)), None, ValueError, "value width 64"),
    (((1, 8, 4, 128), (1, 8, 2, 128), (1, 8, 2, 64)), None, ValueError, "value width 64"),
    (((1, 8, 4, 192), (1, 8, 2, 128), (1, 8, 2, 128)), None, ValueError, "same B and dqk"),
    (((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16)), torch.float16, TypeError, "dtype"),
    (((1, 8, 4, 16), (1, 0, 2, 16), (1, 0, 2, 16)), None, ValueError, "T >= 1"),
])
def test_wrapper_refuses_what_the_kernel_cannot_take(shapes, dtypes, exc, match):
    args = [torch.zeros(s, dtype=dtypes or torch.float32) for s in shapes]
    with pytest.raises(exc, match=match):
        flash.flash_attention(*args)
