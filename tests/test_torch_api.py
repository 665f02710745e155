"""``repro_torch.sort`` against ``repro.sort`` on the sim backend.

Every case sends the same numpy input through both packages (the port on
the CPU) and compares keys, values / order, counts, send_counts,
overflowed, the ladder's retries and the final config, bit for bit. Also
the errors both raise, what the port refuses as not yet ported, the
device rule, and that the port loads neither JAX nor ``repro``.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch import convert
from torch_parity import (assert_sort_equal, make_keys, np_dtype, port_config, port_limits,
                          port_np, sort_both, world_mesh)

RNG = np.random.default_rng(3)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _pallas(use_pallas: bool, p: int = 4, **cfg):
    return dict(config=repro.SortConfig(tile=256, use_pallas=use_pallas, **cfg),
                limits=repro.SortLimits(n_procs=p))


@pytest.mark.parametrize("kdtype,vdtype,order", [("float32", "float32", "asc"),
                                                 ("float16", "bfloat16", "desc"),
                                                 ("uint32", "uint16", "asc")])
def test_values_payload_pallas(kdtype, vdtype, order):
    """User values with few distinct keys: the network's tie rule (break on
    the value) decides the payload order, as in repro's Pallas path."""
    keys = make_keys(RNG, 2000, kdtype, distinct=6)
    vals = make_keys(RNG, 2000, vdtype)
    assert_sort_equal(*sort_both(keys, vals, order=order, **_pallas(True)))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("layout", ["grid", "nondivisible", "fewer-than-p"])
def test_layouts(layout, use_pallas):
    if layout == "grid":
        keys, p = make_keys(RNG, (4, 700), "float32"), 4
    elif layout == "nondivisible":
        keys, p = make_keys(RNG, 1001, "int32", distinct=50), 7
    else:
        keys, p = np.array([3, -1, 2], np.int32), 8
    kw = _pallas(use_pallas, p)
    assert_sort_equal(*sort_both(keys, **kw))
    assert_sort_equal(*sort_both(keys, want="order", **kw))


def test_duplicates_and_naive_bounds():
    keys = make_keys(RNG, 4096, "int32", distinct=4)
    assert_sort_equal(*sort_both(keys, want="order", **_pallas(True, 8)))
    kw = _pallas(False, 8)
    kw["limits"] = repro.SortLimits(n_procs=8, raise_on_overflow=False)
    assert_sort_equal(*sort_both(keys, investigator=False, **kw))


def test_scatter_branch_through_sort():
    """n_local > 8192 with the kernels on: the late local merge rounds take
    the scatter merge."""
    keys = make_keys(RNG, 2 * 9000, "float32")
    assert_sort_equal(*sort_both(keys, want="order", config=repro.SortConfig(),
                                 limits=repro.SortLimits(n_procs=2)))


@pytest.mark.parametrize("want", ["values", "order"])
def test_overflow_ladder_through_sort(want):
    keys = make_keys(RNG, 4096, "int32", distinct=4)
    r, t = sort_both(keys, want=want, investigator=False,
                     **_pallas(False, 8, capacity_factor=0.3))
    assert r.meta.retries > 0
    assert_sort_equal(r, t)


def test_overflow_ladder_exhausted():
    keys = make_keys(RNG, 4096, "float32")
    cfg = repro.SortConfig(capacity_factor=0.01, use_pallas=False)
    lim = repro.SortLimits(max_doublings=1, raise_on_overflow=False)
    r, t = sort_both(keys, config=cfg, limits=lim)
    assert r.overflowed and t.overflowed
    assert_sort_equal(r, t)
    with pytest.raises(repro_torch.SortOverflowError, match="capacity_factor=0.02"):
        repro_torch.sort(keys, config=convert.config_from_dict(
            {"capacity_factor": 0.01, "use_pallas": False}),
            limits=repro_torch.SortLimits(max_doublings=1), device="cpu")


def _errors_of(fn_repro, fn_port):
    with pytest.raises(Exception) as want:
        fn_repro()
    with pytest.raises(Exception) as got:
        fn_port()
    return want.value, got.value


@pytest.mark.parametrize("keys,kw", [
    (np.array([1, 2**31 - 1, 3], np.int32), dict(want="order")),
    (np.array([1, -128, 3], np.int8), dict(want="order", order="desc")),
    (np.array([1, 2**32 - 1], np.uint32), dict(values=np.arange(2, dtype=np.int32))),
    (np.array([1.0, np.inf], np.float32), dict(want="order")),
    (np.array([1.0, np.nan, 2.0], np.float32), dict(want="order")),
    (np.array([1.0, -np.inf], np.float16), dict(want="order", order="desc")),
    (np.array([1.0, np.inf], np_dtype("bfloat16")), dict(want="order")),
    (np.arange(4, dtype=np.int32), dict(want="order", values=np.arange(4, dtype=np.int32))),
    (np.arange(4, dtype=np.int32), dict(want="argsort")),
    (np.arange(4, dtype=np.int32), dict(order="up")),
])
def test_errors_match_repro(keys, kw):
    """Sentinel or NaN keys with a payload, want="order" with values, bad
    arguments: the same exception type and text as repro."""
    want, got = _errors_of(lambda: repro.sort(keys, where="sim", **kw),
                           lambda: repro_torch.sort(keys, device="cpu", **kw))
    assert type(got) is type(want) is ValueError
    assert str(got) == str(want)


@pytest.mark.parametrize("dtype", ["int64", "float64", "uint64"])
def test_64bit_dtypes_refused_at_the_door(dtype):
    """With x64 mode off (the default of both packages) both refuse 64-bit
    keys and values with a TypeError naming the opt-in; with it on the
    port sorts them (tests/test_torch_x64.py holds those sorts to
    repro's)."""
    keys = np.arange(4).astype(dtype)[::-1].copy()
    with repro_torch.x64_mode(False):
        want, got = _errors_of(lambda: repro.sort(keys, where="sim"),
                               lambda: repro_torch.sort(keys, device="cpu"))
        assert type(want) is type(got) is TypeError
        assert "REPRO_X64=1" in str(got) and "SortLimits(x64=True)" in str(got)
        with pytest.raises(TypeError, match="x64 mode"):
            repro_torch.sort(np.arange(4, dtype=np.float32), np.arange(4), device="cpu")
    with repro_torch.x64_mode():
        out = repro_torch.sort(keys, device="cpu")
    assert out.keys.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(port_np(out.keys), np.sort(keys))


@pytest.mark.parametrize("call,item", [
    (lambda k: repro_torch.sort((k, k), where=(world_mesh(), "data"), device="cpu"),
     "item 9.1"),
    (lambda k: repro_torch.sort(iter([k.astype(np.int64)]), device="cpu").keys, "item 2"),
    (lambda k: repro_torch.sort(
        k, where="stream", limits=repro_torch.SortLimits(x64=True), device="cpu"), "item 2"),
    (lambda k: repro_torch.sort((k, k), where=world_mesh(), device="cpu"), "item 9.1"),
    (lambda k: repro_torch.sort((k, k), where=(world_mesh(), ("data",)), order=("asc", "desc"),
                                device="cpu"), "item 9.1"),
    (lambda k: repro_torch.sort(
        (k, k), limits=repro_torch.SortLimits(stream_threshold=10, x64=True), device="cpu"),
     "item 2"),
    (lambda k: repro_torch.sort(
        k, limits=repro_torch.SortLimits(trace=True, x64=True), device="cpu"), "item 2"),
    (lambda k: repro_torch.sort(
        (k, k), where=world_mesh(), limits=repro_torch.SortLimits(decode="host", trace=True),
        device="cpu"), "item 9.1"),
    (lambda k: repro_torch.sort(
        k, limits=repro_torch.SortLimits(x64=True), device="cpu"), "item 2"),
])
def test_not_ported_raises_naming_the_roadmap_item(call, item):
    """What the port once refused, naming its ROADMAP item, now sorts. The
    "item 9.1" cases are multi-key sorts over the mesh (a one-rank mesh
    here; 8 ranks against ``repro`` in tests/test_torch_mesh.py), with the
    mode on or off. The "item 2" cases are x64 mode: each sorts, with the
    mode on or pinned by SortLimits(x64=True); with the mode off a 64-bit
    stream chunk raises repro's TypeError."""
    k = np.arange(100, dtype=np.int32)
    assert item in ("item 2", "item 9.1")
    outs = []
    with repro_torch.x64_mode(False):
        try:
            outs.append(call(k))
        except TypeError as e:
            assert "64-bit stream chunk keys (int64) need x64 mode" in str(e)
    with repro_torch.x64_mode():
        outs.append(call(k))
    for out in outs:
        keys = getattr(out, "keys", out)
        for col in keys if isinstance(keys, tuple) else (keys,):
            np.testing.assert_array_equal(port_np(col), k)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.arange(10, dtype=np.float32)
    for fn in (repro_torch.sort, repro_torch.plan, repro_torch.explain):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(keys)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.sort(torch.from_numpy(keys), device="cuda")
    assert repro_torch.plan(keys, device="cpu").device == torch.device("cpu")


def test_outputs_are_tensors_in_the_callers_dtypes():
    keys = make_keys(RNG, 500, "uint16")
    vals = make_keys(RNG, 500, "bfloat16")
    out = repro_torch.sort(keys, vals, device="cpu", config=repro_torch.SortConfig(
        use_pallas=False))
    assert out.keys.dtype == torch.uint16 and out.values.dtype == torch.bfloat16
    assert out.keys.device.type == "cpu" and len(out) == 500
    np.testing.assert_array_equal(convert.to_numpy(out.keys), np.sort(keys))
    empty = repro_torch.sort(np.zeros(0, np.float32), want="order", device="cpu")
    assert empty.keys.shape == (0,) and empty.order().dtype == torch.int32


def test_plan_and_explain_match_repro():
    keys = make_keys(RNG, (4, 300), "int16")
    want = repro.plan(keys, want="order", order="desc")
    got = repro_torch.plan(keys, want="order", order="desc", device="cpu")
    assert (got.backend, got.n_procs, got.key_width) == (want.backend, want.n_procs,
                                                         want.key_width)
    assert got.reasons == want.reasons
    text = repro_torch.explain(keys, device="cpu")
    assert text.startswith("repro_torch.sort plan: backend='sim'") and "device=cpu" in text
    lim = port_limits(repro.SortLimits(n_procs=3, growth=1.5))
    assert lim == repro_torch.SortLimits(n_procs=3, growth=1.5)


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.models.model, repro_torch.serve.engine, repro_torch.kernels.flash\n"
        "sort = [m for m in sys.modules if m.startswith('repro_torch.core')]\n"
        "assert not sort, ('serving imported the sort', sort)\n"
        "import pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
    for script in [SRC.parent / "chip_smoke.py", *(SRC.parent / "tools").glob("*.py")]:
        text = script.read_text()
        for banned in ("import jax", "from jax", "import repro\n", "from repro ",
                       "from repro.", "import repro."):
            assert banned not in text, (script.name, banned)


def _nan_keys() -> np.ndarray:
    """20000 float32 keys in [-50, 50) with +-0.0 ties and 5% NaN."""
    rng = np.random.default_rng(0)
    keys = rng.integers(-50, 50, 20000).astype(np.float32)
    keys[keys == 0] = np.where(rng.random((keys == 0).sum()) < 0.5, 0.0, -0.0)
    keys[rng.random(keys.shape) < 0.05] = np.nan
    return keys


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("order", ["asc", "desc"])
def test_nan_keys_match_repro(order, use_pallas):
    """Keys-only float sorts whose keys hold NaN: repro loses some keys to
    colliding ranks (NaN breaks its searches), and the port keeps exactly
    what repro keeps, because it then searches with jax's probes and order
    (ops.jax_searchsorted) and resolves collisions as XLA's scatter does."""
    keys = _nan_keys()
    r, t = sort_both(keys, order=order, config=repro.SortConfig(tile=512, use_pallas=use_pallas))
    assert_sort_equal(r, t)
    assert np.isnan(np.asarray(r.keys)).sum() > 0


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kw", [dict(values=np.arange(20000, dtype=np.int32)),
                                dict(values=np.ones(20000, np.float32), order="desc"),
                                dict(want="order"), dict(want="order", order="desc")])
def test_nan_keys_with_a_payload_raise_as_repro(kw, use_pallas):
    """Payload sorts (values, or want="order") of keys holding NaN are
    refused before they sort, with repro's text: the jax-order search and
    collision rule exist only on the keys-only path."""
    cfg = repro.SortConfig(tile=512, use_pallas=use_pallas)
    keys = _nan_keys()
    want, got = _errors_of(lambda: repro.sort(keys, where="sim", config=cfg, **kw),
                           lambda: repro_torch.sort(keys, config=port_config(cfg), device="cpu",
                                                    **kw))
    assert type(got) is type(want) is ValueError
    assert str(got) == str(want)


def test_nan_free_float_sorts_keep_torch_searchsorted(monkeypatch):
    """The jax-order search runs only when a keys-only float sort's keys
    hold a NaN: never for NaN-free floats or integers."""
    from repro_torch.kernels import ops

    calls = []
    search = ops.jax_searchsorted
    monkeypatch.setattr(ops, "jax_searchsorted", lambda *a, **k: (calls.append(1), search(*a, **k))[1])
    cfg = repro_torch.SortConfig(tile=512, use_pallas=False)
    keys = _nan_keys()
    for clean in (np.nan_to_num(keys), np.arange(5000, dtype=np.int32)[::-1].copy()):
        for kw in ({}, {"order": "desc"}, {"want": "order"}):
            repro_torch.sort(clean, config=cfg, device="cpu", **kw)
    assert not calls
    repro_torch.sort(keys, config=cfg, device="cpu")
    assert calls
