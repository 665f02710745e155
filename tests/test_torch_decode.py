"""The host decode (``SortLimits(decode="host")``) of ``repro_torch``.

It copies the result grid to the CPU and decodes it with numpy, as
``repro``'s legacy path does (``unpad_grid``, the reverse or inverse flip,
``_stable_order_fix``, ``keyenc.unpack_np``). Every case holds it bit for
bit against the port's device decode on the same input, and against
``repro.sort(..., where="sim", limits=SortLimits(decode="host"))``:
keys-only, payload and ``want="order"`` sorts, ascending and descending,
single keys of every admitted dtype, packed and LSD multi-key sorts.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.core import planner
from torch_parity import (DTYPES, assert_bits_equal, assert_multikey_equal, assert_sort_equal,
                          make_keys, port_config, port_limits, port_np, sort_both,
                          sort_both_raising)

RNG = np.random.default_rng(23)
KINDS = {
    "keys": {}, "keys desc": dict(order="desc"), "order": dict(want="order"),
    "order desc": dict(want="order", order="desc"), "values": "values",
    "values desc": "values desc",
}


def _kw(kind: str, n: int) -> dict:
    kw = KINDS[kind]
    if isinstance(kw, str):
        kw = dict(values=make_keys(RNG, n, "uint32"), order="desc" if "desc" in kw else "asc")
    return dict(kw)


def _device_and_host(keys, config, limits, **kw):
    """The port's sort of ``keys`` with each decode."""
    out = {}
    for decode in ("device", "host"):
        lim = dataclasses.replace(port_limits(limits), decode=decode)
        out[decode] = repro_torch.sort(keys, config=port_config(config), limits=lim,
                                       device="cpu", **kw)
    return out["device"], out["host"]


def _same_output(a, b) -> None:
    ka, kb = (a.keys, b.keys) if isinstance(a.keys, tuple) else ((a.keys,), (b.keys,))
    for x, y in zip(ka, kb, strict=True):
        assert x.dtype == y.dtype and y.device.type == "cpu"
        assert_bits_equal(port_np(x), port_np(y))
    assert (a.values is None) == (b.values is None)
    if a.values is not None:
        assert a.values.dtype == b.values.dtype
        assert_bits_equal(port_np(a.values), port_np(b.values))
    np.testing.assert_array_equal(a.counts, b.counts)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_single_key_host_decode(dtype, kind):
    """Host decode == device decode == repro's host decode. A descending
    bfloat16 sort with a payload (values or want="order") is the exception
    on repro's side: its host flip
    applies ``~`` to an ml_dtypes bfloat16 array and raises TypeError
    (a reference fault, ROADMAP.md §3); the port's host decode flips the
    float32 view and equals its device decode."""
    n = 1001
    keys = make_keys(RNG, n, dtype)
    kw = _kw(kind, n)
    config, limits = repro.SortConfig(use_pallas=False), repro.SortLimits(n_procs=4)
    dev, host = _device_and_host(keys, config, limits, **kw)
    _same_output(dev, host)
    assert "decode=host" in host.meta.plan.explain()
    hl = dataclasses.replace(limits, decode="host")
    if dtype == "bfloat16" and kind in ("order desc", "values desc"):
        with pytest.raises(TypeError, match="invert"):
            repro.sort(keys, where="sim", config=config, limits=hl, **kw).keys
        return
    assert_sort_equal(*sort_both(keys, config=config, limits=hl, **kw))


@pytest.mark.parametrize("layout", ["grid", "nondivisible"])
@pytest.mark.parametrize("kind", ["keys desc", "order", "values desc"])
def test_host_decode_layouts_and_kernels(layout, kind):
    """(p, n_local) and non-divisible inputs, with the kernels' twins
    (use_pallas=True): repro's Pallas path in interpret mode."""
    keys = (make_keys(RNG, (4, 300), "float32") if layout == "grid"
            else make_keys(RNG, 1001, "int16", distinct=40))
    kw = _kw(kind, keys.size)
    if "values" in kw:
        kw["values"] = kw["values"].reshape(keys.shape)
    config = repro.SortConfig(tile=128)
    limits = repro.SortLimits(n_procs=3, decode="host")
    dev, host = _device_and_host(keys, config, limits, **kw)
    _same_output(dev, host)
    assert_sort_equal(*sort_both(keys, config=config, limits=limits, **kw))


@pytest.mark.parametrize("want", ["values", "order", "kv"])
@pytest.mark.parametrize("multikey", ["auto", "lsd"])
@pytest.mark.parametrize("orders", [("asc", "asc"), ("desc", "asc"), ("asc", "desc")])
def test_multikey_host_decode(orders, multikey, want):
    """Packed (the tie fix on the packed keys, then unpack_np) and LSD
    passes (each pass decoded on the host, the gathers on the CPU)."""
    n = 1500
    keys = (RNG.integers(-4, 4, n).astype(np.int8), RNG.integers(1, 300, n).astype(np.uint16))
    values = RNG.integers(0, 1 << 20, n).astype(np.int32) if want == "kv" else None
    kw = dict(order=orders, want="order" if want == "order" else "values")
    config = repro.SortConfig(use_pallas=False)
    limits = repro.SortLimits(n_procs=4, multikey=multikey, decode="host")
    dev, host = _device_and_host(keys, config, limits, values=values, **kw)
    assert host.meta.multikey == ("packed" if multikey == "auto" else "lsd")
    _same_output(dev, host)
    assert_multikey_equal(*sort_both_raising(keys, values, config=config, limits=limits, **kw))


def test_host_helpers_match_repro():
    """unpad_grid and _stable_order_fix against repro's on the same grid."""
    from repro.core import planner as jplanner

    grid = RNG.integers(0, 5, (4, 50)).astype(np.float32)
    grid.sort(axis=1)
    counts = np.array([50, 20, 0, 33])
    m = 90
    ks = planner.unpad_grid(grid, counts, m)
    np.testing.assert_array_equal(ks, jplanner.unpad_grid(grid, counts, m))
    idx = RNG.permutation(m).astype(np.int32)
    ks.sort()
    np.testing.assert_array_equal(planner._stable_order_fix(ks, idx),
                                  jplanner._stable_order_fix(ks, idx))
    assert planner._stable_order_fix(ks[:1], idx[:1]) is not None


def test_host_decode_returns_cpu_tensors_for_an_empty_sort():
    out = repro_torch.sort((np.zeros(0, np.int8), np.zeros(0, np.int8)), want="order",
                           limits=repro_torch.SortLimits(decode="host"), device="cpu")
    assert out.keys[0].shape == (0,) and out.order().dtype == torch.int32
