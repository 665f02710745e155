"""The port on the card: each CUDA kernel against its plain twin, and the
whole ``repro_torch.sort`` path on CUDA against the same path on the CPU
(which the other ``test_torch_*`` files hold against ``repro``).

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
    x = torch.randint(0, distinct, (rows, n), generator=gen, device=device)
    if dtype == torch.float32:
        x = (x - distinct // 2).to(torch.float32) / 3
        return torch.where(torch.rand(x.shape, generator=gen, device=device) < 0.5, x, -x)
    return x.to(dtype)


@pytest.mark.parametrize("n", [2, 64, 1024, 8192])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.int8, torch.bfloat16])
def test_kernels_equal_twins(gpu, n, dtype):
    gen = torch.Generator(device=gpu).manual_seed(n)
    k = _rows(gen, 8, n, dtype, 7, gpu)
    v = _rows(gen, 8, n, torch.int32, 1000, gpu)
    before = bitonic.bitonic_sort_rows.launches
    assert torch.equal(bitonic.bitonic_sort_rows(k).view(torch.int8),
                       bitonic.bitonic_sort_rows(k.cpu()).to(gpu).view(torch.int8))
    assert bitonic.bitonic_sort_rows.launches == before + 1
    for stable in (True, False):
        ok, ov = bitonic.bitonic_sort_rows_kv(k, v, stable=stable)
        tk, tv = bitonic.bitonic_sort_rows_kv(k.cpu(), v.cpu(), stable=stable)
        assert torch.equal(ok.cpu().view(torch.int8), tk.view(torch.int8))
        assert torch.equal(ov.cpu(), tv)
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
