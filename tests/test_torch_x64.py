"""x64 mode of ``repro_torch`` against ``repro``'s, bit for bit.

``repro``'s side runs once per module in a subprocess
(``tests/torch_x64_reference.py``, with ``REPRO_X64=1``): its x64 mode
flips jax's process-wide ``jax_enable_x64`` flag, which under
``pytest -n 6 --dist loadfile`` would leak into the next test file on
the same worker. The inputs are the seeded numpy cases of
``tests/torch_x64_cases.py``; the port runs them in-process under its own
``x64_mode()``, on the CPU: int64 / uint64 / float64 keys and payloads,
sim and stream, both decodes, both orders, keys / a payload /
``want="order"``, ``use_pallas`` False and True (the kernels' twins), the
63-bit packed tuple and its saturated-sentinel ValueError, the
over-budget LSD fallback naming 63, float64 NaN keys-only, int64
provenance at a lowered cap, ``SortLimits(x64=False)`` under the ambient
mode, the door's TypeError; and the four kernels' twins at 8 bytes
against ``repro``'s Pallas kernels in interpret mode.

The door's text differs from ``repro``'s in two places, which
``port_text`` spells out: the port names its own opt-in
(``repro_torch.enable_x64()``), and it has no jax flag to explain.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import x64_enabled, x64_mode
from repro_torch.core import keyenc
from repro_torch.core import x64 as port_x64
from repro_torch.kernels import bitonic
from torch_parity import assert_bits_equal, port_np, tt
import torch_x64_cases

HERE = pathlib.Path(__file__).resolve().parent
CASES = torch_x64_cases.cases()
TWINS = torch_x64_cases.twin_cases()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case through ``repro`` in x64 mode, in a process of its own."""
    out = tmp_path_factory.mktemp("x64") / "ref.npz"
    path = os.pathsep.join([str(HERE.parent / "src"), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, REPRO_X64="1", JAX_PLATFORMS="cpu", PYTHONPATH=path)
    proc = subprocess.run([sys.executable, str(HERE / "torch_x64_reference.py"), str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def port_text(repro_message: str) -> str:
    """``repro``'s x64 message as the port words it."""
    return (repro_message
            .replace(": without jax x64 the device sort would truncate to 32 bits and the "
                     "padding sentinel overflows.", ".")
            .replace("repro.enable_x64()", "repro_torch.enable_x64()"))


def _error(e: Exception) -> str:
    return f"{type(e).__name__}: {e}"


def port_sort(case: dict):
    """The case through ``repro_torch.sort`` on the CPU, in x64 mode."""
    limits = repro_torch.SortLimits(**case["limits"])
    config = repro_torch.SortConfig(**case["config"])
    out = repro_torch.sort(case["keys"], case["values"], limits=limits, config=config,
                           device="cpu", **case["kw"])
    out.keys  # a stream result materializes here
    return out


@pytest.fixture
def cap(monkeypatch):
    def lower(value):
        if value is not None:
            monkeypatch.setattr(keyenc, "PROVENANCE_INT32_CAP", value)
    return lower


@pytest.mark.parametrize("name", list(CASES))
def test_sort_matches_repro_x64(ref, cap, name):
    case = CASES[name]
    cap(case["cap"])
    with x64_mode():
        if case["plan"]:
            plan = repro_torch.plan(case["keys"], case["values"], device="cpu",
                                    limits=repro_torch.SortLimits(**case["limits"]),
                                    config=repro_torch.SortConfig(**case["config"]),
                                    **case["kw"])
            assert "\n".join(plan.reasons) == str(ref[f"{name}/reasons"])
        try:
            got = port_sort(case)
        except Exception as e:  # noqa: BLE001 - the same error as repro's
            assert f"{name}/error" in ref, _error(e)
            assert _error(e) == port_text(str(ref[f"{name}/error"]))
            return
    assert f"{name}/error" not in ref, ref.get(f"{name}/error")
    keys = got.keys if isinstance(got.keys, tuple) else (got.keys,)
    assert len(keys) == sum(k.startswith(f"{name}/keys") for k in ref)
    for i, k in enumerate(keys):
        want = ref[f"{name}/keys{i}"]
        assert port_np(k).dtype == want.dtype
        assert_bits_equal(want, port_np(k))
    if f"{name}/values" in ref:
        want = ref[f"{name}/values"]
        assert port_np(got.values).dtype == want.dtype
        assert_bits_equal(want, port_np(got.values))
    else:
        assert got.values is None
    if f"{name}/counts" in ref:
        np.testing.assert_array_equal(np.asarray(got.counts), ref[f"{name}/counts"])


@pytest.mark.parametrize("name", list(TWINS))
def test_twins_match_pallas_at_8_bytes(ref, name):
    """The wrappers on the CPU (the twins; uint64 by its lane) against
    ``repro``'s Pallas kernels in interpret mode, in x64 mode."""
    kind, arrays, stable = TWINS[name]
    fn = {"sort": bitonic.bitonic_sort_rows, "sort_kv": bitonic.bitonic_sort_rows_kv,
          "merge": bitonic.bitonic_merge_rows, "merge_kv": bitonic.bitonic_merge_rows_kv}[kind]
    kw = dict(stable=stable) if kind.endswith("kv") else {}
    got = fn(*map(tt, arrays), **kw)
    for i, g in enumerate(got if isinstance(got, tuple) else (got,)):
        want = ref[f"twin {name}/out{i}"]
        assert port_np(g).dtype == want.dtype
        assert_bits_equal(want, port_np(g))


@pytest.mark.parametrize("n,x64", [(16, False), (17, False), (16, True), (17, True)])
def test_provenance_dtype_at_a_lowered_cap(ref, monkeypatch, n, x64):
    """Past ``PROVENANCE_INT32_CAP`` (lowered to 16, as repro's own test
    does) the index widens to int64 in x64 mode, and raises repro's
    TypeError without it."""
    monkeypatch.setattr(keyenc, "PROVENANCE_INT32_CAP", 16)
    want = str(ref[f"provenance/dtype_{n}_{x64}"])
    try:
        got = keyenc.dtype_name(keyenc.provenance_dtype(n, x64=x64))
    except TypeError as e:
        got = _error(e)
    assert got == port_text(want)


def test_encode_provenance_widens_under_x64(ref, monkeypatch):
    monkeypatch.setattr(keyenc, "PROVENANCE_INT32_CAP", 16)
    with x64_mode(False):
        with pytest.raises(TypeError, match="x64"):
            repro_torch.encode_provenance(4, 5, device="cpu")
        assert repro_torch.encode_provenance(4, 4, device="cpu").dtype == torch.int32
    with x64_mode():
        wide = repro_torch.encode_provenance(4, 5, device="cpu")
        narrow = repro_torch.encode_provenance(4, 4, device="cpu")
    assert_bits_equal(ref["provenance/encode_4_5"], port_np(wide))
    assert_bits_equal(ref["provenance/encode_4_4"], port_np(narrow))
    p, i = repro_torch.decode_provenance(wide, 5)
    np.testing.assert_array_equal(port_np(p), np.arange(20).reshape(4, 5) // 5)
    np.testing.assert_array_equal(port_np(i), np.arange(20).reshape(4, 5) % 5)


@pytest.mark.parametrize("dtype,what", [("int64", "keys"), ("uint64", "keys"),
                                        ("float64", "keys"), ("float64", "values payload")])
def test_door_refuses_64_bits_with_the_mode_off(ref, dtype, what):
    """repro's TypeError, naming the opt-in and the cast (the int64 text is
    the reference's own)."""
    keys = np.arange(8).astype(dtype)
    with x64_mode(False):
        with pytest.raises(TypeError) as e:
            if what == "keys":
                repro_torch.sort(keys, device="cpu")
            else:
                repro_torch.sort(np.arange(8, dtype=np.float32), keys, device="cpu")
    narrow = {"int64": "int32", "uint64": "uint32", "float64": "float32"}[dtype]
    assert str(e.value) == (
        f"64-bit {what} ({dtype}) need x64 mode, which is off. Opt in with "
        f"repro_torch.enable_x64(), REPRO_X64=1, or SortLimits(x64=True) — or cast to "
        f"{narrow} first (note np defaults Python ints to int64).")
    case = {("int64", "keys"): "x64=False pins 32 bits",
            ("float64", "values payload"): "x64=False float64 values"}.get((dtype, what))
    if case is not None:
        assert _error(e.value) == port_text(str(ref[f"{case}/error"]))


def test_x64_mode_is_scoped_and_reads_the_environment(monkeypatch):
    monkeypatch.setattr(port_x64, "_STATE", {"enabled": None})
    monkeypatch.delenv("REPRO_X64", raising=False)
    assert not x64_enabled()
    monkeypatch.setenv("REPRO_X64", "1")
    assert x64_enabled()  # read at the check, not at import
    with x64_mode(False):
        assert not x64_enabled()
        with x64_mode():
            assert x64_enabled()
        assert not x64_enabled()
    assert x64_enabled()
    repro_torch.enable_x64(False)
    assert not x64_enabled()
    k = np.arange(5, dtype=np.int64)[::-1].copy()
    out = repro_torch.sort(k, device="cpu", limits=repro_torch.SortLimits(x64=True))
    assert out.keys.dtype == torch.int64 and out.meta.plan.x64
    np.testing.assert_array_equal(port_np(out.keys), np.arange(5))


def test_narrow_path_is_the_same_in_either_mode():
    """A 32-bit sort and a tuple that fits 31 bits plan and sort the same
    with the mode on or off: the same int32 pack, the same bits."""
    rng = np.random.default_rng(42)
    k = rng.integers(-1000, 1000, 257).astype(np.int32)
    t = (rng.integers(0, 1 << 10, 257).astype(np.int16), rng.integers(-50, 50, 257).astype(np.int8))
    got = {}
    for on in (False, True):
        with x64_mode(on):
            o1 = repro_torch.sort(k, device="cpu")
            o2 = repro_torch.sort(t, order=("asc", "desc"), device="cpu")
            got[on] = (o1, o2, o2.meta.plan)
    (a1, a2, pa), (b1, b2, pb) = got[False], got[True]
    assert_bits_equal(port_np(a1.keys), port_np(b1.keys))
    for x, y in zip(a2.keys, b2.keys):
        assert_bits_equal(port_np(x), port_np(y))
    assert pa.packspec == pb.packspec and pa.packspec.pack_dtype == torch.int32
    assert [r for r in pa.reasons] == [r for r in pb.reasons] and pa.key_width == pb.key_width
    assert not pa.x64 and pb.x64


def _wide_recipes():
    ts, shard = torch_x64_cases.ts_shard(500, 1)
    u = torch_x64_cases.column("uint64", 500, 2) >> np.uint64(40)
    f = np.abs(torch_x64_cases.column("float64", 500, 3))
    g = np.random.default_rng(4).uniform(1.0, 1.5, 500)  # one exponent
    return {
        "ts asc, shard desc": ((ts, shard), (False, True), None),
        "shard desc, ts asc": ((shard, ts), (True, False), None),
        "uint64 24 bits, declared int64": ((u, ts - ts.min()), (False, False), (None, 35)),
        "float64 one exponent, int32": ((g, shard), (True, False), None),
        "float64 wide band": ((f, shard), (False, False), None),
        "saturated 63": (torch_x64_cases.saturated(), (False, False), None),
        "full-range int64": ((torch_x64_cases.column("int64", 500, 5), shard), (False, False),
                             None),
    }


@pytest.mark.parametrize("name", list(_wide_recipes()))
def test_wide_pack_recipe_matches_repro(name):
    """The 63-bit budget: ``plan_pack``'s spec and reason (the float64
    exponent band's words included), ``pack_keys``' int64 word and both
    unpacks, against ``repro``'s numpy recipe (``budget=63``)."""
    from repro.core import keyenc as jkeyenc

    cols, desc, key_bits = _wide_recipes()[name]
    want_spec, want_why = jkeyenc.plan_pack(cols, desc, key_bits, budget=63)
    spec, why = keyenc.plan_pack([tt(c) for c in cols], desc, key_bits, budget=63)
    assert why == want_why
    if want_spec is None:
        assert spec is None
        return
    assert [vars(f) for f in spec.fields] == [vars(f) for f in want_spec.fields]
    packed = keyenc.pack_keys([tt(c) for c in cols], spec)
    assert keyenc.dtype_name(packed.dtype) == np.dtype(want_spec.pack_dtype).name
    np.testing.assert_array_equal(port_np(packed), jkeyenc.pack_keys(cols, want_spec))
    for c, dev, host in zip(cols, keyenc.unpack_fields(packed, spec),
                            keyenc.unpack_np(port_np(packed), spec)):
        assert_bits_equal(c, port_np(dev))
        assert_bits_equal(c, host)
