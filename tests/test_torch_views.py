"""The ``SortOutput`` views and ``core.topk`` against ``repro``'s.

``topk``, ``searchsorted`` (left and right, descending results, NaN and
+-0.0 queries, ties), ``percentile_sorted`` (numpy's linear
interpolation, bit for bit), ``provenance()`` on (p, n_local) and flat
inputs, ``searchsorted_in_result``, ``local_topk`` and ``load_imbalance``:
the same seeded numpy input through ``repro`` and through the port on the
CPU. ``repro``'s ``*_sorted`` views are numpy functions, so they also
judge the port's on 64-bit keys without jax's x64 flag; the sorts
themselves are 32-bit here (64-bit sorts: tests/test_torch_x64.py).
"""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import api as japi
from repro.core import topk as jtopk
from repro_torch.core import keyenc, topk
from torch_parity import assert_bits_equal, make_keys, np_dtype, port_np, tt

RNG = np.random.default_rng(19)
# the views do not depend on the kernels: repro's Pallas path (interpret
# mode on the CPU) would only cost time here
JCFG, TCFG = repro.SortConfig(tile=256, use_pallas=False), repro_torch.SortConfig(tile=256,
                                                                                   use_pallas=False)
DTYPES = ["float32", "float64", "float16", "bfloat16", "int32", "uint32", "int64", "uint64",
          "int16", "uint16"]


def sorted_keys(dtype: str, n: int = 300, seed: int = 0) -> np.ndarray:
    """Sorted keys with ties (and +-0.0 among floats)."""
    rng = np.random.default_rng(seed)
    if dtype in ("int64", "uint64"):
        info = np.iinfo(dtype)
        pool = rng.integers(info.min, info.max, 40, dtype=dtype, endpoint=True)
        x = pool[rng.integers(0, 40, n)]
    elif dtype == "float64":
        x = rng.normal(size=40)[rng.integers(0, 40, n)] * 1e100
        x[::5], x[::7] = 0.0, -0.0
    else:
        x = make_keys(rng, n, dtype, distinct=None if "float" in dtype else None)
        x = x[rng.integers(0, n // 4, n)]
    return np.sort(x, kind="stable")


def queries_for(keys: np.ndarray, dtype: str, seed: int = 1) -> np.ndarray:
    """Hits, misses, the ends and beyond; +-0.0, +-inf and NaN for floats
    (not for bfloat16: numpy searches ml_dtypes' bfloat16 with a compare
    that does not order NaN, and its answer for the next query depends on
    it)."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([keys[rng.integers(0, keys.size, 20)], keys[:1], keys[-1:]])
    if "float" in dtype:
        nan = [] if dtype == "bfloat16" else [np.nan]
        extra = np.array([0.0, -0.0, np.inf, -np.inf, *nan, 1e-3], np.float64)
        return np.concatenate([q.astype(np.float64), extra]).astype(np_dtype(dtype))
    info = np.iinfo(dtype)
    return np.concatenate([q, np.array([info.min, info.max, 0], dtype)]).astype(dtype)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_searchsorted_sorted_matches_repro(dtype, side, descending):
    keys = sorted_keys(dtype)
    if descending:
        keys = keys[::-1].copy()
    q = queries_for(keys, dtype)
    want = jtopk.searchsorted_sorted(keys, q, side=side, descending=descending)
    got = topk.searchsorted_sorted(tt(keys), tt(q), side=side, descending=descending)
    assert got.dtype == torch.int64 and got.shape == q.shape
    np.testing.assert_array_equal(port_np(got), want)


@pytest.mark.parametrize("q", [1.5, [0.5, -1.0], np.float64(np.nan), 7])
def test_searchsorted_promotes_queries_as_numpy(q):
    """A float query into int32 keys compares as float64, as numpy does;
    a scalar query gives a scalar rank."""
    keys = np.arange(-5, 10, dtype=np.int32)
    want = jtopk.searchsorted_sorted(keys, q)
    got = topk.searchsorted_sorted(tt(keys), q)
    np.testing.assert_array_equal(port_np(got), want)
    assert got.shape == np.shape(want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_topk_sorted_matches_repro(dtype, descending):
    keys = sorted_keys(dtype, 50)
    if descending:
        keys = keys[::-1].copy()
    for k in (0, 1, 7, 50, 60):
        for largest in (True, False):
            want = jtopk.topk_sorted(keys, k, largest=largest, descending=descending)
            got = topk.topk_sorted(tt(keys), k, largest=largest, descending=descending)
            assert_bits_equal(want, port_np(got))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES + ["float32 NaN", "float64 inf"])
def test_percentile_sorted_is_numpys_bit_for_bit(dtype, descending):
    """Bit for bit, up to the sign of a zero: numpy partitions the data
    (introselect) and may put -0.0 where the sorted keys hold +0.0."""
    name = dtype.split()[0]
    keys = sorted_keys(name, 257, 3)
    if dtype.endswith("NaN"):
        keys = np.concatenate([keys, np.full(3, np.nan, keys.dtype)])
    if dtype.endswith("inf"):
        keys = np.concatenate([keys, [np.inf]])
    if descending:
        keys = keys[::-1].copy()
    for q in (50, 0, 100, 33.3, [0, 12.5, 25, 66.7, 99.9, 100], np.linspace(0, 100, 41)):
        want = jtopk.percentile_sorted(keys, q, descending=descending)
        got = topk.percentile_sorted(tt(keys), q, descending=descending)
        assert got.dtype == torch.float64 and got.shape == np.shape(want)
        want, got = np.asarray(want), port_np(got)
        np.testing.assert_array_equal(got, want)  # NaN == NaN, -0.0 == 0.0
        nonzero = want != 0
        assert_bits_equal(want[nonzero], got[nonzero])
    with pytest.raises(ValueError, match=r"\[0, 100\]"):
        topk.percentile_sorted(tt(keys), 101)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "int32", "uint32", "int16"])
def test_local_topk_values_match_repro(dtype, largest):
    x = make_keys(RNG, 500, dtype)
    wv, _ = jtopk.local_topk(np.asarray(x), 9, largest=largest)
    gv, gi = topk.local_topk(tt(x), 9, largest=largest)
    assert_bits_equal(np.asarray(wv), port_np(gv))
    assert_bits_equal(np.asarray(wv), x[port_np(gi)])


@pytest.mark.parametrize("order", ["asc", "desc"])
@pytest.mark.parametrize("layout", ["grid", "flat"])
def test_sort_output_views_match_repro(layout, order):
    """``topk``, ``searchsorted`` and ``provenance()`` of the same sort in
    both packages: (4, 500) input (provenance = (processor, index)) and
    flat."""
    x = make_keys(RNG, 2000, "float32")
    x[::13] = x[7]  # ties across shards
    keys = x.reshape(4, 500) if layout == "grid" else x
    r = repro.sort(keys, where="sim", order=order, want="order", config=JCFG,
                   limits=repro.SortLimits(n_procs=4))
    t = repro_torch.sort(keys, device="cpu", config=TCFG,
                         limits=repro_torch.SortLimits(n_procs=4), order=order, want="order")
    for k, largest in ((5, True), (5, False), (0, True), (2001, False)):
        assert_bits_equal(r.topk(k, largest), port_np(t.topk(k, largest)))
    q = queries_for(np.sort(x), "float32")
    for side in ("left", "right"):
        np.testing.assert_array_equal(port_np(t.searchsorted(q, side)), r.searchsorted(q, side))
    want, got = r.provenance(), t.provenance()
    if layout == "grid":
        assert isinstance(got, tuple) and len(got) == 2
        for w, g in zip(want, got):
            np.testing.assert_array_equal(port_np(g), w)
        np.testing.assert_array_equal(port_np(got[0]) * 500 + port_np(got[1]), r.order())
    else:
        np.testing.assert_array_equal(port_np(got), want)


def test_views_refuse_what_repro_refuses():
    x = make_keys(RNG, 300, "int32")
    tup = repro_torch.sort((x, x[::-1].copy()), device="cpu", config=TCFG)
    keys_only = repro_torch.sort(x, device="cpu", config=TCFG)
    r_tup, r_keys = repro.sort((x, x[::-1].copy()), config=JCFG), repro.sort(x, config=JCFG)
    for got, want in ((lambda: tup.topk(3), lambda: r_tup.topk(3)),
                      (lambda: tup.searchsorted(x[:3]), lambda: r_tup.searchsorted(x[:3])),
                      (lambda: keys_only.provenance(), lambda: r_keys.provenance())):
        with pytest.raises(ValueError) as e1:
            want()
        with pytest.raises(ValueError) as e2:
            got()
        assert str(e1.value) == str(e2.value)


def test_stream_views_answer_on_the_host():
    """The stream's keys are CPU tensors, and so are its views."""
    x = make_keys(RNG, 5000, "float32")
    lim = dict(chunk_elems=1 << 11, n_procs=4)
    r = repro.sort(x, where="stream", want="order", limits=repro.SortLimits(**lim), config=JCFG)
    t = repro_torch.sort(x, where="stream", want="order", device="cpu",
                         limits=repro_torch.SortLimits(**lim), config=TCFG)
    assert t.topk(4).device.type == "cpu"
    assert_bits_equal(r.topk(4), port_np(t.topk(4)))
    np.testing.assert_array_equal(port_np(t.searchsorted(x[:50])), r.searchsorted(x[:50]))
    np.testing.assert_array_equal(port_np(t.provenance()), r.provenance())


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint32"])
def test_searchsorted_in_result_matches_repro(dtype):
    """(proc, local index) of each query in a (p, cap) padded result."""
    x = make_keys(RNG, 4 * 700, dtype, distinct=50 if dtype != "float32" else None)
    x = x.reshape(4, 700)
    lim = repro.SortLimits(n_procs=4)
    r = repro.sort(x, where="sim", limits=lim, config=JCFG)
    t = repro_torch.sort(x, device="cpu", limits=repro_torch.SortLimits(n_procs=4), config=TCFG)
    q = queries_for(np.sort(x.reshape(-1)), dtype)
    if dtype == "float32":
        q = q[~np.isnan(q)]  # jax's search of NaN depends on the padded grid's probes
    wp, wi = jtopk.searchsorted_in_result(r.raw.values, r.raw.counts, q)
    grid = keyenc.from_lane(t.raw.values, t.keys.dtype)  # the port's grid holds the lanes
    gp, gi = topk.searchsorted_in_result(grid, t.raw.counts, tt(q))
    np.testing.assert_array_equal(port_np(gp), np.asarray(wp))
    np.testing.assert_array_equal(port_np(gi), np.asarray(wi))


@pytest.mark.parametrize("counts", [[5, 5, 5, 5], [0, 0, 0], [1, 2, 3, 10], [7]])
def test_load_imbalance_matches_repro(counts):
    c = np.asarray(counts, np.int32)
    want = np.asarray(japi.load_imbalance(c))
    got = repro_torch.load_imbalance(tt(c))
    assert got.dtype == torch.float32
    assert_bits_equal(want.astype(np.float32), port_np(got))
