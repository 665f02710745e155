"""Parity of the port's sorting kernels with ``repro``'s, on the CPU.

Each plain twin of ``repro_torch.kernels.bitonic`` is held against the
Pallas kernel of ``repro.kernels.bitonic`` in interpret mode, then the
dispatch layer (``ops``) against ``repro.kernels.ops``, all with exact
equality: the same compare-exchange network gives the same output, down
to which of two tied keys (+0.0 and -0.0, or equal keys with different
values) lands where.
"""
import numpy as np
import pytest
import torch

from repro.kernels import bitonic as jbitonic
from repro.kernels import ops as jops
from repro_torch.kernels import bitonic, ops, ref
from torch_parity import assert_bits_equal, jx, make_keys, port_np, tt

RNG = np.random.default_rng(7)


def _rows(rows, n, dtype, distinct=None):
    return make_keys(RNG, (rows, n), dtype, distinct=distinct)


def _sorted_rows(rows, n, dtype, distinct=None):
    return np.sort(_rows(rows, n, dtype, distinct), axis=-1)


@pytest.mark.parametrize("rows,n,dtype", [(1, 2, "float32"), (4, 64, "int32"),
                                          (4, 64, "uint32"), (8, 1024, "float32")])
def test_sort_twin_matches_pallas(rows, n, dtype):
    k = _rows(rows, n, dtype)
    want = jbitonic.bitonic_sort_rows(jx(k), interpret=True)
    assert_bits_equal(want, port_np(bitonic.bitonic_sort_rows(tt(k))))


@pytest.mark.parametrize("kdtype,vdtype,stable", [("float32", "int32", True),
                                                  ("int32", "float32", True),
                                                  ("uint32", "uint32", True),
                                                  ("float32", "int32", False)])
def test_sort_kv_twin_matches_pallas(kdtype, vdtype, stable):
    # few distinct keys: the tie rule decides where each value lands
    k = _rows(4, 256, kdtype, distinct=5)
    v = _rows(4, 256, vdtype, distinct=40)
    wk, wv = jbitonic.bitonic_sort_rows_kv(jx(k), jx(v), stable=stable, interpret=True)
    ok, ov = bitonic.bitonic_sort_rows_kv(tt(k), tt(v), stable=stable)
    assert_bits_equal(wk, port_np(ok))
    assert_bits_equal(wv, port_np(ov))


@pytest.mark.parametrize("rows,n", [(1, 1), (2, 128), (8, 4096)])
@pytest.mark.parametrize("dtype", ["float32", "int32", "uint32"])
def test_merge_twin_matches_pallas(rows, n, dtype):
    a, b = _sorted_rows(rows, n, dtype), _sorted_rows(rows, n, dtype)
    want = jbitonic.bitonic_merge_rows(jx(a), jx(b), interpret=True)
    assert_bits_equal(want, port_np(bitonic.bitonic_merge_rows(tt(a), tt(b))))


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("kdtype,vdtype", [("float32", "int32"), ("int32", "uint32")])
def test_merge_kv_twin_matches_pallas(kdtype, vdtype, stable):
    ak, bk = _sorted_rows(4, 128, kdtype, 6), _sorted_rows(4, 128, kdtype, 6)
    av, bv = _rows(4, 128, vdtype, 30), _rows(4, 128, vdtype, 30)
    wk, wv = jbitonic.bitonic_merge_rows_kv(jx(ak), jx(av), jx(bk), jx(bv), stable=stable,
                                            interpret=True)
    ok, ov = bitonic.bitonic_merge_rows_kv(tt(ak), tt(av), tt(bk), tt(bv), stable=stable)
    assert_bits_equal(wk, port_np(ok))
    assert_bits_equal(wv, port_np(ov))


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16", "float16", "bfloat16"])
def test_narrow_types_widen_and_narrow_back_exactly(dtype):
    """int8/16, uint8/16, f16 and bf16 widen to the kernel's 32-bit types
    and narrow back: bit-exact against the Pallas kernel run on the narrow
    type itself, and in the caller's dtype."""
    k = _rows(2, 64, dtype)
    k.reshape(-1)[:32] = k.reshape(-1)[32:64]  # ties
    out = bitonic.bitonic_sort_rows(tt(k))
    assert out.dtype == tt(k).dtype
    assert_bits_equal(jbitonic.bitonic_sort_rows(jx(k), interpret=True), port_np(out))
    if dtype not in ("int8", "bfloat16"):
        return
    v = k[:, ::-1].copy()
    wk, wv = jbitonic.bitonic_sort_rows_kv(jx(k), jx(v), interpret=True)
    ok, ov = bitonic.bitonic_sort_rows_kv(tt(k), tt(v), stable=True)
    assert ok.dtype == ov.dtype == tt(k).dtype
    assert_bits_equal(wk, port_np(ok))
    assert_bits_equal(wv, port_np(ov))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("rows,n,dtype", [(1, 8, "int16"), (8, 555, "bfloat16"),
                                          (16, 1024, "float32")])
def test_ops_sort_rows(rows, n, dtype, use_pallas):
    k = _rows(rows, n, dtype)
    want = jops.sort_rows(jx(k), use_pallas=use_pallas)
    assert_bits_equal(want, port_np(ops.sort_rows(tt(k), use_pallas=use_pallas)))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("n", [300, 1024])
def test_ops_sort_rows_kv(n, use_pallas):
    k = _rows(4, n, "float32", distinct=9)
    v = _rows(4, n, "int32", distinct=50)
    wk, wv = jops.sort_rows_kv(jx(k), jx(v), use_pallas=use_pallas)
    ok, ov = ops.sort_rows_kv(tt(k), tt(v), use_pallas=use_pallas)
    assert_bits_equal(wk, port_np(ok))
    assert_bits_equal(wv, port_np(ov))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("rows,n", [(2, 1000), (2, 8192)])
def test_ops_merge_rows(rows, n, use_pallas):
    """n = 8192 makes 2N > MAX_PALLAS_ROW: the scatter-merge branch."""
    a = _sorted_rows(rows, n, "float32")
    b = _sorted_rows(rows, n, "float32")
    want = jops.merge_rows(jx(a), jx(b), use_pallas=use_pallas)
    assert_bits_equal(want, port_np(ops.merge_rows(tt(a), tt(b), use_pallas=use_pallas)))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("n", [500, 8192])
def test_ops_merge_rows_kv(n, use_pallas):
    ak, bk = _sorted_rows(2, n, "int32", 30), _sorted_rows(2, n, "int32", 30)
    av, bv = _rows(2, n, "int32", 1000), _rows(2, n, "int32", 1000)
    wk, wv = jops.merge_rows_kv(jx(ak), jx(av), jx(bk), jx(bv), use_pallas=use_pallas)
    ok, ov = ops.merge_rows_kv(tt(ak), tt(av), tt(bk), tt(bv), use_pallas=use_pallas)
    assert_bits_equal(wk, port_np(ok))
    assert_bits_equal(wv, port_np(ov))


@pytest.mark.parametrize("n,tile,dtype", [(100, 64, "float32"), (5000, 512, "float32"),
                                          (20000, 1024, "float32"), (3000, 256, "uint8"),
                                          (3000, 256, "bfloat16")])
def test_ops_tile_sort(n, tile, dtype):
    x = make_keys(RNG, n, dtype)
    want = jops.tile_sort(jx(x), tile=tile)
    assert_bits_equal(want, port_np(ops.tile_sort(tt(x), tile=tile)))


@pytest.mark.parametrize("n,tile", [(1000, 128), (20000, 2048)])
def test_ops_tile_sort_kv(n, tile):
    keys = make_keys(RNG, n, "int32", distinct=16)
    vals = make_keys(RNG, n, "float32")
    wk, wv = jops.tile_sort_kv(jx(keys), jx(vals), tile=tile)
    ok, ov = ops.tile_sort_kv(tt(keys), tt(vals), tile=tile)
    assert_bits_equal(wk, port_np(ok))
    assert_bits_equal(wv, port_np(ov))


def test_tile_sort_batched_rows_equal_one_row_at_a_time():
    """A (p, n) batch sorts each row as repro's vmap over rows does."""
    x = make_keys(RNG, (4, 600), "float32")
    batched = port_np(ops.tile_sort(tt(x), tile=128))
    for r in range(4):
        assert_bits_equal(jops.tile_sort(jx(x[r]), tile=128), batched[r])


def test_refs_sort_stably():
    k = _rows(3, 100, "int32", distinct=4)
    v = np.tile(np.arange(100, dtype=np.int32), (3, 1))
    sk, sv = ref.sort_rows_kv_ref(tt(k), tt(v))
    np.testing.assert_array_equal(port_np(sv), np.argsort(k, axis=-1, kind="stable"))
    assert_bits_equal(port_np(sk), np.sort(k, axis=-1))
    assert_bits_equal(port_np(ref.sort_rows_ref(tt(k), descending=True)),
                      np.sort(k, axis=-1)[:, ::-1])
    m = ref.merge_rows_ref(tt(np.sort(k, -1)), tt(np.sort(k, -1)))
    assert_bits_equal(port_np(m), np.sort(np.concatenate([k, k], -1), -1))


def test_wrapper_refuses_other_devices_and_bad_rows():
    with pytest.raises(ValueError, match="power of two"):
        bitonic.bitonic_sort_rows(torch.zeros((2, 12)))
    with pytest.raises(ValueError, match="want cuda or cpu"):
        bitonic.bitonic_sort_rows(torch.zeros((2, 8), device="meta"))
    with pytest.raises(TypeError, match="unsupported dtype"):
        bitonic.bitonic_sort_rows(torch.zeros((2, 8), dtype=torch.float64))


def test_cpu_twins_count_no_launches():
    bitonic.reset_launches()
    k = tt(_rows(2, 64, "float32"))
    bitonic.bitonic_sort_rows(k)
    bitonic.bitonic_merge_rows(k[:, :32].sort().values, k[:, 32:].sort().values)
    assert all(fn.launches == 0 for fn in bitonic.KERNELS)
