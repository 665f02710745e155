"""The port on the card: each CUDA kernel against its plain twin, and the
whole ``repro_torch.sort`` path and the smoke-size model's prefill and
generation on CUDA against the same paths on the CPU (which the other
``test_torch_*`` files hold against ``repro``).

Needs an NVIDIA GPU with nvcc; skipped elsewhere. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.kernels import bitonic

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rows(gen, rows, n, dtype, distinct, device):
    """Keys from ``distinct`` values; float ones with +-0.0 ties, and,
    where ``distinct`` >= 7, +-inf and (float32 only: the two devices
    narrow a NaN to bfloat16 with other bits) NaN."""
    x = torch.randint(0, distinct, (rows, n), generator=gen, device=device)
    if dtype in (torch.float32, torch.bfloat16):
        f = (x - distinct // 2).to(torch.float32) / 3
        f = torch.where(torch.rand(x.shape, generator=gen, device=device) < 0.5, f, -f)
        if distinct >= 7:
            f = torch.where(x == 0, torch.full_like(f, float("inf")), f)
            f = torch.where(x == 1, torch.full_like(f, float("-inf")), f)
            if dtype == torch.float32:
                f = torch.where(x == 2, torch.full_like(f, float("nan")), f)
        return f.to(dtype)
    if dtype == torch.uint32:
        return (x.to(torch.int32) * 7919 ^ (-(1 << 31))).view(torch.uint32)
    return x.to(dtype)


@pytest.mark.parametrize("n", [1 << e for e in range(1, 14)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32, torch.int8,
                                   torch.bfloat16])
def test_kernels_equal_twins(gpu, n, dtype):
    """Bit for bit against the twins: 1, 3 and a number of rows that leaves
    the row sort's last CTA short, every value type, stable on and off."""
    gen = torch.Generator(device=gpu).manual_seed(n)
    per_cta = bitonic.sort_rows_per_cta(n)
    for rows in (1, 3, 2 * per_cta + 1 if per_cta > 1 else 5):
        k = _rows(gen, rows, n, dtype, 7, gpu)
        before = bitonic.bitonic_sort_rows.launches
        assert torch.equal(bitonic.bitonic_sort_rows(k).cpu().view(torch.int8),
                           bitonic.bitonic_sort_rows(k.cpu()).view(torch.int8))
        assert bitonic.bitonic_sort_rows.launches == before + 1
        for vdtype in (torch.int32, torch.uint32, torch.float32):
            v = _rows(gen, rows, n, vdtype, 7, gpu)
            for stable in (True, False):
                ok, ov = bitonic.bitonic_sort_rows_kv(k, v, stable=stable)
                tk, tv = bitonic.bitonic_sort_rows_kv(k.cpu(), v.cpu(), stable=stable)
                assert torch.equal(ok.cpu().view(torch.int8), tk.view(torch.int8))
                assert torch.equal(ov.cpu().view(torch.int8), tv.view(torch.int8))
    k = _rows(gen, 8, n, dtype, 7, gpu)
    v = _rows(gen, 8, n, torch.int32, 1000, gpu)
    if n <= 4096:
        a = bitonic.bitonic_sort_rows(k)
        b = bitonic.bitonic_sort_rows(_rows(gen, 8, n, dtype, 7, gpu))
        want = bitonic.bitonic_merge_rows(a.cpu(), b.cpu())
        assert torch.equal(bitonic.bitonic_merge_rows(a, b).cpu().view(torch.int8),
                           want.view(torch.int8))
        ok, ov = bitonic.bitonic_merge_rows_kv(a, v, b, v)
        tk, tv = bitonic.bitonic_merge_rows_kv(a.cpu(), v.cpu(), b.cpu(), v.cpu())
        assert torch.equal(ok.cpu().view(torch.int8), tk.view(torch.int8))
        assert torch.equal(ov.cpu(), tv)


def test_row_sort_takes_unaligned_views_and_refuses_unaligned_pointers(gpu):
    """The row-sort kernel moves 16 bytes at a time: the wrapper copies a
    view that starts off a 16-byte boundary, and the C entry point refuses
    such a pointer instead of faulting."""
    buf = torch.randn(4 * 1024 + 1, generator=torch.Generator(device=gpu).manual_seed(0),
                      device=gpu)
    k = buf[1:].view(4, 1024)
    assert k.data_ptr() % 16 != 0
    assert torch.equal(bitonic.bitonic_sort_rows(k).cpu(), bitonic.sort_rows_twin(k.cpu()))
    ok, ov = bitonic.bitonic_sort_rows_kv(k, k)
    tk, tv = bitonic.sort_rows_twin(k.cpu(), k.cpu())
    assert torch.equal(ok.cpu(), tk) and torch.equal(ov.cpu(), tv)
    out = torch.empty_like(k)
    with pytest.raises(RuntimeError, match="invalid argument"):
        bitonic._launch("bitonic_sort_rows", k.data_ptr(), out.data_ptr(), 4, 1024,
                        bitonic._TYPE_CODES[k.dtype], bitonic._stream(k))


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, {"order": "desc"}, {"want": "order"},
                                {"want": "order", "order": "desc"}])
def test_sort_on_cuda_equals_sort_on_cpu(gpu, dtype, kw):
    rng = np.random.default_rng(0)
    keys = rng.integers(-50, 50, 20000).astype(np.float32)
    keys = convert.to_tensor(keys, "cpu").to(getattr(torch, dtype)) if dtype != "uint32" \
        else convert.to_tensor(rng.integers(1, 2**32 - 1, 20000).astype(np.uint32), "cpu")
    cfg = repro_torch.SortConfig(tile=512)
    got = repro_torch.sort(keys, config=cfg, device=gpu, **kw)
    want = repro_torch.sort(keys, config=cfg, device="cpu", **kw)
    assert got.keys.device.type == "cuda"
    g, w = convert.output_to_numpy(got), convert.output_to_numpy(want)
    for name in ("keys", "values", "counts", "send_counts"):
        if w[name] is None:
            assert g[name] is None
        else:
            np.testing.assert_array_equal(g[name], w[name])


def test_wrapper_raises_on_cuda_instead_of_falling_back(gpu):
    with pytest.raises(TypeError, match="unsupported dtype"):
        bitonic.bitonic_sort_rows(torch.zeros((2, 8), dtype=torch.float64, device=gpu))
    with pytest.raises(ValueError, match="power of two"):
        bitonic.bitonic_merge_rows(torch.zeros((2, 8192), device=gpu),
                                   torch.zeros((2, 8192), device=gpu))


# ---------------------------------------------------------------- model tier


@pytest.mark.parametrize("shape", [(1, 256, 4, 2, 16), (2, 1000, 4, 1, 64),
                                   (1, 8192, 32, 8, 128), (2, 8192, 32, 8, 128),
                                   (1, 77, 8, 8, 32), (2, 1000, 8, 2, 128),
                                   (1, 77, 8, 8, 128)])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_twin(gpu, shape, dtype, tol, causal):
    """Max abs err within ``tol`` of the Pallas-faithful twin; in bf16 also
    within ``bf16_error``'s limit of the twin that rounds where the kernel
    does (one bf16 ulp of each output plus 2^-6 of its row's rms, mean
    err <= 1e-3 rms)."""
    from repro_torch.kernels import flash

    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, KV, dh = shape
    gen = torch.Generator(device=gpu).manual_seed(S)
    q, k, v = (torch.randn((B, S, h, dh), generator=gen, device=gpu).to(dtype)
               for h in (H, KV, KV))
    before = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v, causal=causal)
    assert flash.flash_attention.launches == before + 1
    want = flash.flash_attention_twin(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, H, dh)
    assert float((got.float() - want.float()).abs().max()) <= tol
    if dtype == torch.bfloat16:
        err = flash.bf16_error(got, flash.kernel_twin(q, k, v, causal=causal))
        assert err["ok"], err


def test_flash_wrapper_raises_on_cuda_instead_of_falling_back(gpu):
    from repro_torch.kernels import flash

    q = torch.zeros((1, 8, 4, 24), device=gpu)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(TypeError, match="dtype"):
        h = torch.zeros((1, 8, 4, 16), device=gpu, dtype=torch.float16)
        flash.flash_attention(h, h, h)


def test_flash_tma_encode_failure_raises(gpu, monkeypatch):
    """A tensor map that the driver refuses surfaces as an error from
    flash_attention: here a q whose base is off TMA's 16-byte alignment,
    with the wrapper's own alignment step taken out. The kernel does not
    launch."""
    from repro_torch.kernels import flash

    monkeypatch.setattr(flash, "_aligned", lambda t: t)
    buf = torch.zeros(1 * 64 * 2 * 64 + 8, device=gpu, dtype=torch.bfloat16)
    q = buf[1:1 + 64 * 2 * 64].view(1, 64, 2, 64)  # 2 bytes past an aligned base
    kv = torch.zeros((1, 64, 2, 64), device=gpu, dtype=torch.bfloat16)
    before = flash.flash_attention.launches
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        flash.flash_attention(q, kv, kv)
    assert flash.flash_attention.launches == before


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_model_on_cuda_matches_model_on_cpu(gpu, dtype, tol):
    """The qwen3-4b smoke config at S = 8192 with flash_attention=True:
    on the card the prefill launches the kernel once per layer; on the CPU
    the same weights run the twin (which the CPU tests hold against repro)."""
    import dataclasses

    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels import flash
    from repro_torch.models.model import Model
    from repro_torch.serve import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(smoke_config("qwen3-4b"), dtype=dtype, flash_attention=True)
    m_gpu = Model(cfg, device=gpu, seed=4)
    m_cpu = Model(cfg, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (2, 8192), generator=torch.Generator().manual_seed(0))
    before = flash.flash_attention.launches
    lg_gpu, caches = engine.make_prefill(m_gpu)({"tokens": toks.to(gpu)})
    assert flash.flash_attention.launches == before + cfg.n_layers
    lg_cpu, _ = engine.make_prefill(m_cpu)({"tokens": toks})
    want = lg_cpu.float()
    scale = max(float(want.abs().max()), 1.0)
    assert float((lg_gpu.cpu().float() - want).abs().max()) <= tol * scale
    if dtype == "float32":  # bf16 rounding may flip a near-tie argmax
        got = engine.generate(m_gpu, {"tokens": toks[:, :64].to(gpu)}, 4)
        want = engine.generate(m_cpu, {"tokens": toks[:, :64]}, 4)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
