"""The port on the card: each CUDA kernel against its plain twin, and the
whole ``repro_torch.sort`` path and the smoke-size model's prefill and
generation on CUDA against the same paths on the CPU (which the other
``test_torch_*`` files hold against ``repro``).

Needs an NVIDIA GPU with nvcc; skipped elsewhere. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
import torch_x64_cases
from repro_torch import convert
from repro_torch.core import keyenc
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
    narrow a NaN to bfloat16 with other bits) NaN, integer ones the
    type's extremes."""
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
        u = x.to(torch.int32) * 7919 ^ (-(1 << 31))
        if distinct >= 7:  # 0 and 2^32 - 1
            u = torch.where(x == 0, 0, torch.where(x == 1, -1, u))
        return u.view(torch.uint32)
    if distinct >= 7:
        info = torch.iinfo(dtype)
        x = torch.where(x == 0, info.min, torch.where(x == 1, info.max, x))
    return x.to(dtype)


def _merge_pair(gen, rows, n, dtype, distinct, device, strided: bool, sort: bool):
    """Two (rows, n) merge operands, sorted by the row-sort kernel or not:
    strided, the even and odd rows of one tensor (the merge tree's views,
    row stride 2n); else two contiguous tensors."""
    def make(r):
        x = _rows(gen, r, n, dtype, distinct, device)
        return bitonic.bitonic_sort_rows(x) if sort else x

    if strided:
        x = make(2 * rows)
        return x[0::2], x[1::2]
    return make(rows), make(rows)


def _same_bits(got, want) -> bool:
    return torch.equal(got.cpu().view(torch.int8), want.cpu().view(torch.int8))


@pytest.mark.parametrize("n", [1 << e for e in range(1, 14)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32, torch.int8,
                                   torch.bfloat16])
def test_kernels_equal_twins(gpu, n, dtype):
    """Bit for bit against the twins: 1, 3 and a number of rows that leaves
    the last CTA short, every value type, stable on and off; the row sorts
    on rows of n, the merges into rows of n, from contiguous operands and
    from the merge tree's strided views."""
    gen = torch.Generator(device=gpu).manual_seed(n)
    per_cta = bitonic.sort_rows_per_cta(n)
    for rows in (1, 3, 2 * per_cta + 1 if per_cta > 1 else 5):
        k = _rows(gen, rows, n, dtype, 7, gpu)
        before = bitonic.bitonic_sort_rows.launches
        assert _same_bits(bitonic.bitonic_sort_rows(k), bitonic.bitonic_sort_rows(k.cpu()))
        assert bitonic.bitonic_sort_rows.launches == before + 1
        for vdtype in (torch.int32, torch.uint32, torch.float32):
            v = _rows(gen, rows, n, vdtype, 7, gpu)
            for stable in (True, False):
                ok, ov = bitonic.bitonic_sort_rows_kv(k, v, stable=stable)
                tk, tv = bitonic.bitonic_sort_rows_kv(k.cpu(), v.cpu(), stable=stable)
                assert _same_bits(ok, tk) and _same_bits(ov, tv)
        for strided in (False, True):
            a, b = _merge_pair(gen, rows, n // 2, dtype, 7, gpu, strided, sort=True)
            before = bitonic.bitonic_merge_rows.launches
            assert _same_bits(bitonic.bitonic_merge_rows(a, b),
                              bitonic.bitonic_merge_rows(a.cpu(), b.cpu()))
            assert bitonic.bitonic_merge_rows.launches == before + 1
            for vdtype in (torch.int32, torch.uint32, torch.float32):
                av, bv = _merge_pair(gen, rows, n // 2, vdtype, 7, gpu, strided, sort=False)
                for stable in (True, False):
                    ok, ov = bitonic.bitonic_merge_rows_kv(a, av, b, bv, stable=stable)
                    tk, tv = bitonic.bitonic_merge_rows_kv(a.cpu(), av.cpu(), b.cpu(), bv.cpu(),
                                                           stable=stable)
                    assert _same_bits(ok, tk) and _same_bits(ov, tv)


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


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint32", "bfloat16",
                                   "float32 +-0.0 NaN use_pallas=False",
                                   "float32 +-0.0 NaN use_pallas=True"])
@pytest.mark.parametrize("kw", [{}, {"order": "desc"}, {"want": "order"},
                                {"want": "order", "order": "desc"}])
def test_sort_on_cuda_equals_sort_on_cpu(gpu, dtype, kw):
    """The last dtype cases: float32 keys mixing +-0.0 and NaN through the
    torch.sort path and through the kernels: the searches follow jax's
    probes and the rank merge's collisions keep one writer on both devices
    (ops.jax_searchsorted, ops._last_writers); with want="order" both
    devices refuse the NaN keys with the same error."""
    rng = np.random.default_rng(0)
    keys = rng.integers(-50, 50, 20000).astype(np.float32)
    cfg = repro_torch.SortConfig(tile=512)
    if dtype.startswith("float32 "):
        keys[keys == 0] = np.where(rng.random((keys == 0).sum()) < 0.5, 0.0, -0.0)
        keys[rng.random(keys.shape) < 0.05] = np.nan
        cfg = repro_torch.SortConfig(tile=512, use_pallas=dtype.endswith("True"))
        keys, dtype = convert.to_tensor(keys, "cpu"), "float32"
        if "want" in kw:
            with pytest.raises(ValueError) as want_err:
                repro_torch.sort(keys, config=cfg, device="cpu", **kw)
            with pytest.raises(ValueError) as got_err:
                repro_torch.sort(keys, config=cfg, device=gpu, **kw)
            assert str(got_err.value) == str(want_err.value)
            return
    keys = convert.to_tensor(keys, "cpu").to(getattr(torch, dtype)) if dtype != "uint32" \
        else convert.to_tensor(rng.integers(1, 2**32 - 1, 20000).astype(np.uint32), "cpu")
    got = repro_torch.sort(keys, config=cfg, device=gpu, **kw)
    want = repro_torch.sort(keys, config=cfg, device="cpu", **kw)
    assert got.keys.device.type == "cuda"
    g, w = convert.output_to_numpy(got), convert.output_to_numpy(want)
    for name in ("keys", "values", "counts", "send_counts"):
        if w[name] is None:
            assert g[name] is None
        else:
            np.testing.assert_array_equal(g[name], w[name])


@pytest.mark.parametrize("n", [1 << e for e in range(1, 14)])
@pytest.mark.parametrize("kdtype", ["int64", "float64", "uint64"])
def test_kernels_equal_twins_at_8_bytes(gpu, n, kdtype):
    """The 64-bit instantiations, bit for bit against the twins: keys of
    the whole range with their extremes (+-inf for float64) and
    duplicates, every value type, stable on and off, 1, 3 and a number of
    rows that leaves the last CTA short; the merges from contiguous
    operands and the merge tree's strided views."""
    def rows_of(rows, width, dtype, seed, sort=False):
        x = convert.to_tensor(torch_x64_cases.column(dtype, rows * width, seed, payload_safe=False)
                              .reshape(rows, width), gpu) if dtype in torch_x64_cases.WIDE else \
            _rows(torch.Generator(device=gpu).manual_seed(seed), rows, width,
                  getattr(torch, dtype), 7, gpu)
        return bitonic.bitonic_sort_rows(x) if sort else x

    per_cta = bitonic.sort_rows_per_cta(n)
    vtypes = ("int32", "uint32", "float32", "int64", "uint64", "float64")
    for rows in (1, 3, 2 * per_cta + 1 if per_cta > 1 else 5):
        k = rows_of(rows, n, kdtype, n + rows)
        before = bitonic.bitonic_sort_rows.wide_launches
        assert _same_bits(bitonic.bitonic_sort_rows(k), bitonic.bitonic_sort_rows(k.cpu()))
        assert bitonic.bitonic_sort_rows.wide_launches == before + 1
        for i, vd in enumerate(vtypes):
            v = rows_of(rows, n, vd, 7 * n + i)
            for stable in (True, False):
                ok, ov = bitonic.bitonic_sort_rows_kv(k, v, stable=stable)
                tk, tv = bitonic.bitonic_sort_rows_kv(k.cpu(), v.cpu(), stable=stable)
                assert _same_bits(ok, tk) and _same_bits(ov, tv)
        for strided in (False, True):
            both = rows_of(2 * rows, n // 2, kdtype, 3 * n + rows, sort=True)
            a, b = (both[0::2], both[1::2]) if strided else (both[:rows], both[rows:])
            assert _same_bits(bitonic.bitonic_merge_rows(a, b),
                              bitonic.bitonic_merge_rows(a.cpu(), b.cpu()))
            for i, vd in enumerate(vtypes):
                vals = rows_of(2 * rows, n // 2, vd, 11 * n + i)
                av, bv = (vals[0::2], vals[1::2]) if strided else (vals[:rows], vals[rows:])
                for stable in (True, False):
                    ok, ov = bitonic.bitonic_merge_rows_kv(a, av, b, bv, stable=stable)
                    tk, tv = bitonic.bitonic_merge_rows_kv(a.cpu(), av.cpu(), b.cpu(), bv.cpu(),
                                                           stable=stable)
                    assert _same_bits(ok, tk) and _same_bits(ov, tv)


@pytest.mark.parametrize("name", list(torch_x64_cases.cases()))
def test_x64_sort_on_cuda_equals_cpu(gpu, monkeypatch, name):
    """The x64 cases of tests/test_torch_x64.py (held there to repro's) on
    the card against the same call on the CPU: outputs bit for bit, or the
    same error."""
    case = torch_x64_cases.cases()[name]
    if case["cap"] is not None:
        monkeypatch.setattr(keyenc, "PROVENANCE_INT32_CAP", case["cap"])
    limits = repro_torch.SortLimits(**case["limits"])
    config = repro_torch.SortConfig(**case["config"])
    outs = []
    with repro_torch.x64_mode():
        for dev in (gpu, "cpu"):
            try:
                out = repro_torch.sort(case["keys"], case["values"], limits=limits,
                                       config=config, device=dev, **case["kw"])
                keys = out.keys if isinstance(out.keys, tuple) else (out.keys,)
                outs.append([*keys, out.values, torch.as_tensor(out.counts)])
            except Exception as e:  # noqa: BLE001 - both devices raise the same
                outs.append(f"{type(e).__name__}: {e}")
    got, want = outs
    if isinstance(want, str):
        assert got == want
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        assert w is None or (g.dtype == w.dtype and _same_bits(g, w))


def test_views_on_cuda_equal_cpu(gpu):
    """topk, searchsorted and provenance of a card sort: tensors on the
    card, equal to the CPU's."""
    x = torch_x64_cases.column("float64", 20000, 1).reshape(4, 5000)
    q = np.concatenate([x.reshape(-1)[:300], [0.0, -0.0, np.nan, np.inf, -np.inf]])
    with repro_torch.x64_mode():
        outs = [repro_torch.sort(x, want="order", order=o, device=d)
                for d in (gpu, "cpu") for o in ("asc", "desc")]
    for got, want in zip(outs[:2], outs[2:]):
        assert got.topk(50).device.type == "cuda"
        for view in (lambda o: o.topk(50), lambda o: o.topk(7, largest=False),
                     lambda o: o.searchsorted(q), lambda o: o.searchsorted(q, "right"),
                     lambda o: o.provenance()[0], lambda o: o.provenance()[1]):
            assert _same_bits(view(got), view(want))


def test_jax_order_search_and_writer_rule_equal_cpu(gpu):
    """ops.jax_searchsorted and the rank merge's NaN path on rows a NaN
    left unsorted: CUDA equals the CPU, collisions included."""
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(3)
    for n in (7, 1000, 9000):
        a, b = (torch.randint(-6, 6, (4, n), generator=gen).float().sort(dim=1).values
                for _ in range(2))
        for x in (a, b):
            x[torch.rand(x.shape, generator=gen) < 0.1] = float("nan")
            x[:, -2:] = float("inf")
        for side in ("left", "right"):
            assert torch.equal(ops.jax_searchsorted(a.to(gpu), b.to(gpu), side).cpu(),
                               ops.jax_searchsorted(a, b, side))
        got = ops._scatter_merge_total_order(a.to(gpu), b.to(gpu))
        assert _same_bits(got, ops._scatter_merge_total_order(a, b))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_nan_free_float_sort_keeps_torch_searchsorted(gpu, monkeypatch, use_pallas):
    """A NaN-free float sort on the card never calls the jax-order search;
    the same keys with a NaN do."""
    from repro_torch.kernels import ops

    calls = []
    search = ops.jax_searchsorted
    monkeypatch.setattr(ops, "jax_searchsorted",
                        lambda *a, **k: (calls.append(1), search(*a, **k))[1])
    keys = torch.rand(1 << 16, generator=torch.Generator().manual_seed(0)).to(gpu)
    cfg = repro_torch.SortConfig(use_pallas=use_pallas)
    out = repro_torch.sort(keys, config=cfg, device=gpu)
    assert torch.equal(out.keys, torch.sort(keys).values) and not calls
    keys[::97] = float("nan")
    repro_torch.sort(keys, config=cfg, device=gpu)
    assert calls


@pytest.mark.parametrize("decode", ["device", "host"])
@pytest.mark.parametrize("multikey", ["packed", "lsd"])
@pytest.mark.parametrize("want", ["values", "order", "kv"])
def test_multikey_on_cuda_equals_cpu(gpu, multikey, decode, want):
    """Multi-key sorts on the card (the packed int32 sort, or LSD passes of
    the kv kernels over int32 provenance values) equal the same call with
    device="cpu" (which the CPU tests hold against repro); the host decode
    returns CPU tensors."""
    rng = np.random.default_rng(1)
    n = 50000
    keys = (rng.integers(0, 1000, n).astype(np.int32),  # 10 + 18 + 3 bits
            rng.integers(1, 1 << 18, n).astype(np.int32), rng.integers(-3, 3, n).astype(np.int8))
    values = rng.random(n).astype(np.float32) if want == "kv" else None
    kw = dict(order=("asc", "desc", "asc"), want="order" if want == "order" else "values",
              limits=repro_torch.SortLimits(multikey=multikey, decode=decode),
              config=repro_torch.SortConfig(tile=512))
    before = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
    got = repro_torch.sort(keys, values, device=gpu, **kw)
    launched = {fn.__name__ for fn in bitonic.KERNELS if fn.launches > before[fn.__name__]}
    want_out = repro_torch.sort(keys, values, device="cpu", **kw)
    assert got.meta.multikey == want_out.meta.multikey == multikey
    assert "bitonic_sort_rows_kv" in launched or (multikey == "packed" and want == "values")
    for g, w in zip(got.keys, want_out.keys, strict=True):
        assert g.device.type == ("cuda" if decode == "device" else "cpu")
        assert _same_bits(g, w)
    assert (got.values is None) == (want_out.values is None)
    if got.values is not None:
        assert _same_bits(got.values, want_out.values)
    np.testing.assert_array_equal(got.counts, want_out.counts)


STREAM = repro_torch.SortLimits(chunk_elems=1 << 12)


@pytest.mark.parametrize("dtype", ["float32", "uint32", "int16", "bfloat16",
                                   "float32 5% NaN"])
@pytest.mark.parametrize("kw", [{}, {"order": "desc"}, {"want": "order"},
                                {"want": "order", "order": "desc"}, {"values": "float32"},
                                {"order": "desc", "decode": "host"}])
def test_stream_on_cuda_equals_stream_on_cpu(gpu, dtype, kw):
    """The stream backend on the card (pinned staging, the copy stream, the
    chunk sorts, the boundary searches and bucket merges on the device)
    equals the same call with device="cpu", which tests/test_torch_stream.py
    holds against repro; the output is CPU tensors either way. NaN keys
    take repro's probes on every pass; with a payload both refuse them."""
    kw = dict(kw)
    rng = np.random.default_rng(2)
    n = 50000
    keys = rng.integers(-300, 300, n).astype(np.float32)
    if dtype.endswith("NaN"):
        keys[rng.random(n) < 0.05] = np.nan
        dtype = "float32"
    keys = (convert.to_tensor(rng.integers(1, 2**32 - 1, n).astype(np.uint32), "cpu")
            if dtype == "uint32" else convert.to_tensor(keys, "cpu").to(getattr(torch, dtype)))
    values = (convert.to_tensor(rng.random(n).astype(np.float32), "cpu")
              if kw.pop("values", None) else None)
    limits = dataclasses.replace(STREAM, decode=kw.pop("decode", "device"))
    call = dict(where="stream", limits=limits, config=repro_torch.SortConfig(tile=512), **kw)
    if bool(keys.isnan().any()) and (values is not None or "want" in kw):
        with pytest.raises(ValueError) as want_err:
            repro_torch.sort(keys, values, device="cpu", **call)
        with pytest.raises(ValueError) as got_err:
            repro_torch.sort(keys, values, device=gpu, **call)
        assert str(got_err.value) == str(want_err.value)
        return
    got = repro_torch.sort(keys, values, device=gpu, **call)
    want = repro_torch.sort(keys, values, device="cpu", **call)
    assert got.keys.device.type == "cpu" and _same_bits(got.keys, want.keys)
    assert (got.values is None) == (want.values is None)
    if got.values is not None:
        assert _same_bits(got.values, want.values)
    assert got.meta.chunk_retries == want.meta.chunk_retries
    np.testing.assert_array_equal(got.counts, want.counts)


@pytest.mark.parametrize("payload", [None, "values", "order"])
def test_stream_double_buffered_staging_equals_torch_sort(gpu, payload):
    """64 chunks of 2^12 keys (and values) through both pinned staging
    buffers and their device buffers: a buffer rewritten before its copy,
    or its chunk's sort, had finished would show here as a wrong key."""
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(64 << 12, generator=gen)
    v = torch.rand(x.shape, generator=gen) if payload == "values" else None
    before = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
    out = repro_torch.sort(x, v, where="stream", limits=STREAM, device=gpu,
                           want="order" if payload == "order" else "values")
    assert torch.equal(out.keys, torch.sort(x).values)
    assert len(out.meta.chunk_retries) == 64
    if payload == "order":
        assert torch.equal(out.order(), torch.sort(x, stable=True).indices.to(torch.int32))
    if payload == "values":
        by_key = torch.sort(x, stable=True).indices
        assert torch.equal(torch.sort(out.values).values, torch.sort(v).values)
        assert torch.equal(x[by_key], out.keys)
    sort = bitonic.KERNELS[0 if payload is None else 1]  # one row sort a chunk sort
    assert sort.launches - before[sort.__name__] == 64 + out.meta.retries


def test_stream_iterator_and_tuple_on_cuda_equal_cpu(gpu):
    """An iterator of ragged host pieces, and a packed tuple whose
    chunks() unpack on the card (keyenc.unpack_chunk), as on the CPU."""
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(100_000, generator=gen)
    got = repro_torch.sort(iter(torch.split(x, 7_777)), limits=STREAM, device=gpu)
    want = repro_torch.sort(iter(torch.split(x, 7_777)), limits=STREAM, device="cpu")
    assert torch.equal(got.keys, want.keys) and torch.equal(got.keys, torch.sort(x).values)
    pair = (torch.randint(0, 100, (50_000,), generator=gen, dtype=torch.int32),
            torch.randint(0, 1 << 12, (50_000,), generator=gen, dtype=torch.int32))
    outs = [repro_torch.sort(pair, where="stream", order=("asc", "desc"), limits=STREAM,
                             device=d) for d in (gpu, "cpu")]
    for g, w in zip(outs[0].chunks(), outs[1].chunks(), strict=True):
        assert all(torch.equal(a, b) for a, b in zip(g, w, strict=True))


def test_flip_and_splitters_keep_nan_bits_on_cuda(gpu):
    """keyenc.flip and splitters.select_splitters (with the sort's NaN
    decision) give the CPU's bits on the card for keys holding NaN of
    either sign: the card's -x and its torch.sort treat such NaN otherwise
    (ROADMAP §3)."""
    from repro_torch.core import keyenc
    from repro_torch.core import splitters as spl

    nan = float("nan")
    x = torch.tensor([1.5, -0.0, 0.0, nan, -nan, float("inf"), -float("inf"), -2.0] * 700)
    for dtype in (torch.float32, torch.float16):
        y = x.to(dtype)
        assert _same_bits(keyenc.flip(y.to(gpu)), keyenc.flip(y))
        assert _same_bits(keyenc.flip(y.to(gpu)), -y)
        assert _same_bits(spl.select_splitters(y.to(gpu), 64, nan_keys=True),
                          spl.select_splitters(y, 64, nan_keys=True))
        z = y[~y.isnan()]  # without NaN both sorts of the samples agree
        assert _same_bits(spl.select_splitters(z.to(gpu), 64),
                          spl.select_splitters(z.to(gpu), 64, nan_keys=True))


def test_traced_sorts_on_cuda_cover_their_window(gpu):
    """SortLimits(trace=True) on the card: a 2^22 sim sort's spans cover at
    least 0.95 of its wall window (repro's gate), as do a stream sort's;
    the traced outputs equal the untraced ones."""
    x = torch.rand(1 << 22, generator=torch.Generator(device=gpu).manual_seed(6), device=gpu)
    for where, keys in (("sim", x), ("stream", x[: 1 << 20].cpu())):
        plain = repro_torch.sort(keys, where=where, device=gpu).keys
        traced = repro_torch.sort(keys, where=where, device=gpu,
                                  limits=repro_torch.SortLimits(trace=True))
        assert torch.equal(plain, traced.keys)  # the stream's passes run at .keys
        tr = traced.meta.trace
        assert tr.frozen and tr.coverage() >= 0.95, (where, tr.coverage())
        assert {"local_sort", "splitter", "merge"} <= set(tr.phase_totals())


def test_merge_tree_views_go_to_the_kernel_without_a_copy(gpu, monkeypatch):
    """ops.merge_rows[_kv] on the merge tree's views of every other run
    (row stride 2n) launch the kernel on the views' own memory: the
    pointers and row strides passed to bitonic._launch are theirs."""
    from repro_torch.kernels import ops

    calls = []
    launch = bitonic._launch
    monkeypatch.setattr(bitonic, "_launch", lambda fn, *args: (calls.append(args),
                                                               launch(fn, *args)))
    gen = torch.Generator(device=gpu).manual_seed(5)
    for n in (1, 4, 8, 1024, 4096):
        keys = bitonic.bitonic_sort_rows(_rows(gen, 16, n, torch.float32, 7, gpu))
        vals = _rows(gen, 16, n, torch.int32, 1000, gpu)
        (ek, ok_), (ev, ov_) = ((x.reshape(2, 8, n)[:, 0::2].reshape(-1, n),
                                 x.reshape(2, 8, n)[:, 1::2].reshape(-1, n)) for x in (keys, vals))
        assert ek._base is keys and not ek.is_contiguous()
        calls.clear()
        out = ops.merge_rows(ek, ok_)
        assert calls[0][:4] == (ek.data_ptr(), 2 * n, ok_.data_ptr(), 2 * n)
        assert _same_bits(out, bitonic.merge_rows_twin(ek.cpu(), ok_.cpu()))
        calls.clear()
        out_k, out_v = ops.merge_rows_kv(ek, ev, ok_, ov_)
        assert calls[0][:8] == (ek.data_ptr(), 2 * n, ev.data_ptr(), 2 * n,
                                ok_.data_ptr(), 2 * n, ov_.data_ptr(), 2 * n)
        tk, tv = bitonic.merge_rows_twin(ek.cpu(), ok_.cpu(), ev.cpu(), ov_.cpu())
        assert _same_bits(out_k, tk) and _same_bits(out_v, tv)


def test_merge_copies_unaligned_views_and_refuses_unaligned_pointers(gpu):
    """The merge kernel reads rows of n >= 8 in 16-byte pieces: the wrapper
    copies a view that breaks them, and the C entry point refuses such a
    pointer or row stride instead of faulting."""
    buf = torch.randn(4 * 1024 + 1, generator=torch.Generator(device=gpu).manual_seed(1),
                      device=gpu)
    a = buf[1:].view(4, 1024)[:, :512].sort(dim=-1).values
    a_view = buf[1:1 + 4 * 512].view(4, 512)
    a_view.copy_(a)
    b = a.flip(0).contiguous()
    assert a_view.data_ptr() % 16 != 0
    assert _same_bits(bitonic.bitonic_merge_rows(a_view, b),
                      bitonic.merge_rows_twin(a_view.cpu(), b.cpu()))
    out = torch.empty((4, 1024), device=gpu)
    for args in ((a_view.data_ptr(), 512, b.data_ptr(), 512),  # unaligned start
                 (b.data_ptr(), 514, b.data_ptr(), 512)):        # row stride off the pieces
        with pytest.raises(RuntimeError, match="invalid argument"):
            bitonic._launch("bitonic_merge_rows", *args, out.data_ptr(), 2, 512,
                            bitonic._TYPE_CODES[b.dtype], bitonic._stream(b))


def test_wrapper_raises_on_cuda_instead_of_falling_back(gpu):
    with pytest.raises(TypeError, match="unsupported dtype"):
        bitonic.bitonic_sort_rows(torch.zeros((2, 8), dtype=torch.complex64, device=gpu))
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
def test_flash_kernel_matches_twin(gpu, shape, dtype, tol, causal, monkeypatch):
    """Max abs err within ``tol`` of the Pallas-faithful twin; in bf16 also
    within ``bf16_error``'s limit of the twin that rounds where the kernel
    does (one bf16 ulp of each output plus 2^-6 of its row's rms, mean
    err <= 1e-3 rms)."""
    from repro_torch.kernels import flash

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
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


@pytest.mark.parametrize("shape", [(1, 8192, 128), (2, 8192, 128), (2, 1000, 4), (1, 77, 8)])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_at_mla_widths_matches_twin(gpu, shape, dtype, tol, causal, monkeypatch):
    """MLA's (dqk, dv) = (192, 128), H = KV (deepseek-v3's 128 heads at
    S = 8192 first, for one sequence and for the two that a served prefill
    gives it): bf16 takes the wgmma kernel with a two-tile ring, float32
    the FMA kernel. The same limits as the equal-width shapes, and float32
    also within 1e-5 x max |twin|."""
    from repro_torch.kernels import flash

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    B, S, H = shape
    gen = torch.Generator(device=gpu).manual_seed(S + H)
    q, k = (torch.randn((B, S, H, 192), generator=gen, device=gpu).to(dtype) for _ in range(2))
    v = torch.randn((B, S, H, 128), generator=gen, device=gpu).to(dtype)
    assert flash.ROUTES[(dtype, 192, 128)] == ("wgmma" if dtype == torch.bfloat16 else "fma")
    before = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v, causal=causal)
    assert flash.flash_attention.launches == before + 1
    want = flash.flash_attention_twin(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, H, 128)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol
    if dtype == torch.float32:
        assert err <= 1e-5 * float(want.abs().max())
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
def test_model_on_cuda_matches_model_on_cpu(gpu, dtype, tol, monkeypatch):
    """The qwen3-4b smoke config at S = 8192 with flash_attention=True:
    on the card the prefill launches the kernel once per layer; on the CPU
    the same weights run the twin (which the CPU tests hold against repro)."""
    import dataclasses

    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels import flash
    from repro_torch.models.model import Model
    from repro_torch.serve import engine

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
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


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-11b"])
def test_memory_model_on_cuda_matches_model_on_cpu(gpu, arch, monkeypatch):
    """The whisper-base and llama-3.2-vision-11b smoke configs in float32
    (TF32 off), the VLM's gates set nonzero: a prefill with memory
    (whisper: 1024 frames through the encoder; the VLM: S = 8192 with
    flash_attention=True, one launch per layer, over 16 vision tokens) and
    4 generated tokens, against the same weights on the CPU (which
    tests/test_torch_cross.py holds against repro)."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels import flash
    from repro_torch.models.model import Model
    from repro_torch.serve import engine

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              flash_attention=bool(smoke_config(arch).n_vision_tokens))
    m_gpu = Model(cfg, device=gpu, seed=5)
    with torch.no_grad():
        for block in m_gpu.layers:
            if getattr(block, "cross", None) is not None and block.cross.gate is not None:
                block.cross.gate.fill_(0.8)
    m_cpu = Model(cfg, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    gen = torch.Generator().manual_seed(1)
    S, (key, M) = ((8192, ("vision", cfg.n_vision_tokens)) if cfg.n_vision_tokens
                   else (16, ("frames", 1024)))
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, S), generator=gen),
             key: torch.randn((2, M, cfg.d_model), generator=gen)}
    on_gpu = {k: v.to(gpu) for k, v in batch.items()}
    before = flash.flash_attention.launches
    with torch.no_grad():
        lg_gpu, caches = engine.make_prefill(m_gpu)(on_gpu)
        assert flash.flash_attention.launches == before + (cfg.n_layers if S >= 8192 else 0)
        lg_cpu, _ = engine.make_prefill(m_cpu)(batch)
        assert float((lg_gpu.cpu() - lg_cpu).abs().max()) <= 1e-4 * float(lg_cpu.abs().max())
        got = engine.generate(m_gpu, on_gpu, 4)
        want = engine.generate(m_cpu, batch, 4)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_mla_model_on_cuda_matches_model_on_cpu(gpu, monkeypatch):
    """The deepseek-v3 smoke config at MLA's published head widths (192,
    128) in float32 (TF32 off), S = 8192 with flash_attention=True: the
    prefill launches the kernel once per layer, and its logits and
    compressed caches, and then the generated tokens, equal the same
    weights on the CPU within 1e-4 x max."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels import flash
    from repro_torch.models.model import Model
    from repro_torch.serve import engine

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(smoke_config("deepseek-v3-671b"), dtype="float32",
                              flash_attention=True, qk_nope_dim=128, qk_rope_dim=64,
                              v_head_dim=128)
    m_gpu = Model(cfg, device=gpu, seed=7)
    m_cpu = Model(cfg, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (1, 8192), generator=torch.Generator().manual_seed(7))
    before = flash.flash_attention.launches
    lg_gpu, c_gpu = engine.make_prefill(m_gpu)({"tokens": toks.to(gpu)})
    assert flash.flash_attention.launches == before + cfg.n_layers
    lg_cpu, c_cpu = engine.make_prefill(m_cpu)({"tokens": toks})
    scale = max(float(lg_cpu.abs().max()), 1.0)
    assert float((lg_gpu.cpu() - lg_cpu).abs().max()) <= 1e-4 * scale
    for g, c in zip(c_gpu, c_cpu, strict=True):
        for name in ("c_kv", "k_pe"):
            want = c["mix"][name]
            assert float((g["mix"][name].cpu() - want).abs().max()) <= 1e-4 * float(
                want.abs().max())
    got = engine.generate(m_gpu, {"tokens": toks[:, :64].to(gpu)}, 4)
    want = engine.generate(m_cpu, {"tokens": toks[:, :64]}, 4)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_moe_on_cuda_equals_cpu(gpu, monkeypatch):
    """The deepseek-moe-16b smoke config in float32: the prefill's MoE
    dispatch on the card launches the kv row sort and kv merge kernels
    (``stable_argsort``), and the logits, the aux loss and the generated
    tokens equal the same weights on the CPU (kernels' twins)."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.serve import engine

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(smoke_config("deepseek-moe-16b"), dtype="float32")
    m_gpu = Model(cfg, device=gpu, seed=5)
    m_cpu = Model(cfg, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (2, 1024), generator=torch.Generator().manual_seed(1))
    bitonic.reset_launches()
    lg_gpu, aux_gpu = m_gpu({"tokens": toks.to(gpu)})[::2]
    launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
    # 2048 x 2 assignments: one tile sort, merges into 2048 and 4096
    assert launches == {"bitonic_sort_rows": 0, "bitonic_sort_rows_kv": 1,
                        "bitonic_merge_rows": 0, "bitonic_merge_rows_kv": 2}, launches
    lg_cpu, aux_cpu = m_cpu({"tokens": toks})[::2]
    scale = max(float(lg_cpu.abs().max()), 1.0)
    assert float((lg_gpu.cpu() - lg_cpu).abs().max()) <= 1e-4 * scale
    assert abs(float(aux_gpu) - float(aux_cpu)) <= 1e-5
    got = engine.generate(m_gpu, {"tokens": toks[:, :64].to(gpu)}, 4)
    want = engine.generate(m_cpu, {"tokens": toks[:, :64]}, 4)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())

    ids = torch.randint(0, 64, (24_576,), generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32)
    for path in (True, False):
        k, o = keyenc.stable_argsort(ids.to(gpu), use_pallas=path)
        wk, wo = keyenc.stable_argsort(ids, use_pallas=True)
        assert torch.equal(k.cpu(), wk) and torch.equal(o.cpu(), wo)
    layer = m_gpu.layers[1]
    x = torch.randn(2, 300, cfg.d_model, device=gpu)
    a = moe.moe_forward(x, layer.moe, cfg, use_pallas=True)
    b = moe.moe_forward(x, layer.moe, cfg, use_pallas=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_train_step_on_cuda_equals_cpu(gpu, monkeypatch):
    """The deepseek-moe-16b smoke config in float32 (TF32 off): two train
    steps at grad_accum 2 from the same weights and batches on the card
    (kernels) and on the CPU (twins), batches from ``PackedLoader`` on the
    card: metrics, parameters and AdamW's m and v within 1e-5 x their
    largest |value| (parameters: plus 1% of the summed learning rates, as
    tests/test_torch_train.py holds the CPU to ``repro``)."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import DataConfig, PackedLoader
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(smoke_config("deepseek-moe-16b"), dtype="float32", remat=True)
    tcfg = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10))
    data = DataConfig(seq_len=128, global_batch=2, grad_accum=2, vocab=cfg.vocab,
                      bucket_docs=256)
    batches = [b for _, b in zip(range(2), PackedLoader(data, device=gpu))]
    cpu_batches = [b for _, b in zip(range(2), PackedLoader(data, device="cpu"))]
    for a, b in zip(batches, cpu_batches):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    runs = []
    for dev in (gpu, torch.device("cpu")):
        m = Model(cfg, device=dev, seed=6)
        if runs:
            m.load_state_dict({k: v.cpu() for k, v in runs[0][0].items()})
        params, ost = init_train_state(m, tcfg)
        start = {k: v.detach().clone() for k, v in params.items()}
        step = make_train_step(m, tcfg)
        metrics = [step(params, ost, s, b)[2] for s, b in zip((1, 2), batches)]
        runs.append((start, params, ost, metrics))
    (_, gp, gs, gm), (_, cp, cs, cm) = runs
    for a, b in zip(gm, cm):
        for k in b:
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-5, abs=1e-7), k
    lr_sum = sum(float(m["lr"]) for m in cm)
    top = max(float(t.abs().max()) for t in cp.values())
    for k in cp:
        assert float((gp[k].detach().cpu() - cp[k].detach()).abs().max()) <= (
            1e-5 * top + 1e-2 * lr_sum), k
    for kind in ("m", "v"):
        top = max(float(t.abs().max()) for t in cs[kind].values())
        for k in cs[kind]:
            assert float((gs[kind][k].cpu() - cs[kind][k]).abs().max()) <= 1e-5 * top, k


def test_moe_gradients_kernel_sort_equal_plain_sort_on_cuda(gpu, monkeypatch):
    """One MoE layer's forward and backward in float32 on the card with the
    dispatch sort through the kernels and through ``torch.sort``: the same
    routing bit for bit, the input and parameter gradients within 1e-5 x
    max|grad| (scatter-adds on the card may sum in another order)."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import moe

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(smoke_config("deepseek-moe-16b"), dtype="float32",
                              moe_capacity_factor=1.25)
    layer = moe.init_moe(cfg, torch.Generator(device=gpu).manual_seed(3), gpu)
    x = torch.randn(2, 512, cfg.d_model, device=gpu)
    outs = []
    for path in (True, False):
        xg = x.clone().requires_grad_(True)
        bitonic.reset_launches()
        o, aux = moe.moe_forward(xg, layer, cfg, use_pallas=path)
        grads = torch.autograd.grad((o ** 2).mean() + 0.01 * aux, [xg, *layer.parameters()])
        launched = sum(fn.launches for fn in bitonic.KERNELS)
        outs.append((o.detach(), aux.detach(), grads, launched))
    (o1, a1, g1, n1), (o2, a2, g2, n2) = outs
    assert n1 > 0 and n2 == 0
    assert torch.equal(o1, o2) and torch.equal(a1, a2)
    for a, b in zip(g1, g2):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# ------------------------------------------------------------ serve tier


def _flush_case(case, rng):
    """(datas, run_group kwargs) of one bucket of 4096 at p = 8."""
    from repro_torch.core import planner

    sizes = [3000, 4096, 2500, 4000, 3500]
    if case == "packed":
        lim = planner.SortLimits(key_bits=(10, 12))
        datas, spec = [], None
        for n in sizes:
            cols = (rng.integers(0, 1 << 10, n).astype(np.int32),
                    rng.integers(0, 1 << 12, n).astype(np.int32))
            req, plan, ok = planner.serve_profile(cols, order=("asc", "desc"), limits=lim,
                                                  device="cpu")
            assert ok
            spec = plan.packspec
            datas.append(keyenc.pack_keys(req.keys, spec, ranks=req.pack_ranks))
        return datas, {"packspec": spec}
    datas = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for n in sizes]
    if case == "nan":  # one member with NaN and +-0.0
        x = datas[1]
        x[::7] = 0.0
        x[::11] = -0.0
        x[::13] = float("nan")
    return datas, {"descending": case in ("descending", "nan")}


@pytest.mark.parametrize("case", ["plain", "descending", "nan", "packed", "on_device"])
def test_flush_on_cuda_equals_flush_on_cpu(gpu, case):
    """The batched flush (bitonic kernels on the card) gives the CPU's
    bits (twins), ladder steps and stats; requests already on the card
    are staged there."""
    from repro_torch.stream.service import FlushEngine

    datas, kw = _flush_case(case, np.random.default_rng(len(case)))
    cpu = FlushEngine(n_procs=8, max_batch=4, device="cpu")
    card = FlushEngine(n_procs=8, max_batch=4, device="cuda")
    want = cpu.run_group(datas, **kw)
    got = card.run_group([d.to(gpu) for d in datas] if case == "on_device" else datas, **kw)
    for (w, ws), (g, gs) in zip(want, got):
        assert gs == ws
        for a, b in zip(w if isinstance(w, tuple) else (w,), g if isinstance(g, tuple) else (g,)):
            assert b.device.type == "cpu" and _same_bits(b, a)
    assert card.stats == cpu.stats


def test_flush_launches_do_not_grow_with_the_batch(gpu):
    """One bucket (float32, p = 8, per = 2^13): B = 1, 4 and 16 requests
    launch each bitonic kernel the same number of times, and the results
    equal torch.sort bit for bit."""
    from repro_torch.stream.service import FlushEngine

    eng = FlushEngine(n_procs=8, device="cuda")
    gen = torch.Generator(device=gpu).manual_seed(0)
    counts = {}
    for b in (1, 4, 16):
        datas = [torch.rand(1 << 16, generator=gen, device=gpu) for _ in range(b)]
        bitonic.reset_launches()
        out = eng.run_group(datas)
        counts[b] = tuple(fn.launches for fn in bitonic.KERNELS)
        for d, (res, steps) in zip(datas, out):
            assert steps == 0 and torch.equal(res, torch.sort(d).values.cpu())
    assert len(set(counts.values())) == 1, counts
    assert counts[1][0] > 0 and counts[1][2] > 0, counts


def test_sort_server_on_cuda_equals_cpu(gpu):
    """Coalesced and direct requests through SortServer on the card give
    the CPU server's bits."""
    from repro_torch.serve.sortd import SortServer

    rng = np.random.default_rng(3)
    reqs = [(rng.standard_normal(n).astype(np.float32), kw)
            for n, kw in ((1000, {}), (900, {"order": "desc"}), (1024, {}),
                          (700, {"want": "order"}), (3000, {}))]
    outs = []
    for dev in ("cpu", "cuda"):
        with SortServer(max_batch=100, max_delay_ms=600_000, device=dev) as srv:
            futs = [srv.submit(x, **kw) for x, kw in reqs]
            srv.flush(timeout=120)
            outs.append([f.result(60) for f in futs])
    for a, b in zip(*outs):
        assert _same_bits(b.keys, a.keys)
        assert (a.values is None) == (b.values is None)
        if a.values is not None:
            assert _same_bits(b.values, a.values)
        assert b.meta.coalesced == a.meta.coalesced


def _card_ranks(tmp_path, backend, world) -> list:
    """Run ``world`` ranks of tests/torch_mesh_card.py on cuda:0 and return
    each rank's npz as a dict."""
    import os
    import pathlib
    import subprocess
    import sys
    import time

    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(here.parent / "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(here / "torch_mesh_card.py"), str(r),
                               str(world), backend, str(tmp_path / "store"), str(tmp_path)],
                              env=env, stdout=f, stderr=subprocess.STDOUT)
             for r, f in enumerate(logs)]
    deadline = time.monotonic() + 300
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    assert [p.returncode for p in procs] == [0] * world, [
        (tmp_path / f"rank{r}.log").read_text()[-3000:] for r in range(world)]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_mesh_sort_on_cuda_equals_the_sim(gpu, tmp_path, backend, world):
    """A one-rank NCCL group, and two gloo ranks sharing cuda:0 (the
    collectives staged through the host), each rank sorting its shard on
    the card (tests/torch_mesh_card.py): the blocks equal the sim with
    n_procs = world on the card, and the counts and send counts too."""
    import torch_mesh_card

    ranks = _card_ranks(tmp_path, backend, world)
    x = torch.from_numpy(torch_mesh_card.keys()).to(gpu)
    for name, kw in torch_mesh_card.CALLS.items():
        want = repro_torch.sort(x, where="sim", limits=repro_torch.SortLimits(n_procs=world),
                                **kw)
        got = np.concatenate([g[f"{name}/keys"] for g in ranks])
        np.testing.assert_array_equal(got, want.keys.cpu().numpy())
        if "want" in kw:
            np.testing.assert_array_equal(np.concatenate([g[f"{name}/values"] for g in ranks]),
                                          want.values.cpu().numpy())
        for g in ranks:
            np.testing.assert_array_equal(g[f"{name}/counts"], want.counts)
            np.testing.assert_array_equal(g[f"{name}/send_counts"], want.send_counts)
            staged = "staged through the host" in str(g[f"{name}/reasons"])
            assert staged == (backend == "gloo")


@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_multikey_mesh_sort_on_cuda_equals_cpu(gpu, tmp_path, backend, world):
    """Tuples over the mesh on the card (tests/torch_mesh_card.py's
    ``MK_CALLS``): a packed pair keys-only and argsorted, an LSD pair with a
    payload; the blocks and counts equal the same sort over a one-rank CPU
    mesh's sim layout (the sim with n_procs = world on the CPU), bit for
    bit."""
    import torch_mesh_card

    ranks = _card_ranks(tmp_path, backend, world)
    for name, kw in torch_mesh_card.MK_CALLS.items():
        cols, values = torch_mesh_card.tuple_inputs(name)
        kw = {k: v for k, v in kw.items() if k != "values"}
        want = repro_torch.sort(cols, values, where="sim", device="cpu",
                                limits=repro_torch.SortLimits(n_procs=world), **kw)
        assert {str(g[f"{name}/multikey"]) for g in ranks} == {want.meta.multikey}
        assert want.meta.multikey == ("lsd" if name == "mk_lsd" else "packed")
        for j, col in enumerate(want.keys):
            got = np.concatenate([g[f"{name}/keys/{j}"] for g in ranks])
            np.testing.assert_array_equal(got.view(np.uint8), col.numpy().view(np.uint8))
        if want.values is not None:
            got = np.concatenate([g[f"{name}/values"] for g in ranks])
            np.testing.assert_array_equal(got.view(np.uint8), want.values.numpy().view(np.uint8))
        for g in ranks:
            np.testing.assert_array_equal(g[f"{name}/counts"], want.counts)


def test_batcher_on_cuda_equals_cpu(gpu, monkeypatch):
    """The qwen3-4b smoke config in float32 (TF32 off) through
    ``ContinuousBatcher`` (2 slots, 3 requests, so one slot is re-used): the
    same tokens on the card as on the CPU with the same weights."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.serve.batching import ContinuousBatcher, Request

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(smoke_config("qwen3-4b"), dtype="float32")
    m_gpu = Model(cfg, device=gpu, seed=6)
    m_cpu = Model(cfg, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(0, cfg.vocab, L).astype(np.int32), n)
            for i, (L, n) in enumerate([(40, 6), (130, 9), (17, 5)])]
    got = ContinuousBatcher(m_gpu, n_slots=2, s_max=160).run([Request(*r) for r in reqs])
    want = ContinuousBatcher(m_cpu, n_slots=2, s_max=160).run([Request(*r) for r in reqs])
    assert got == want and sorted(got) == [0, 1, 2]


@pytest.mark.parametrize("mixer", ["rglru", "mamba"])
def test_recurrent_layer_on_cuda_matches_cpu(gpu, mixer, monkeypatch):
    """One RG-LRU or Mamba layer of the smoke configs in float32 (TF32
    off): a prefill of 1024 (four scan chunks) and three decode steps from
    its cache, outputs and caches within 1e-5 x max of the same layer on
    the CPU (which tests/test_torch_recurrent.py holds against repro)."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import recurrent

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    arch, cls, fwd, init_cache = {
        "rglru": ("recurrentgemma-9b", recurrent.RGLRU, recurrent.rglru_forward,
                  recurrent.init_rglru_cache),
        "mamba": ("falcon-mamba-7b", recurrent.Mamba, recurrent.mamba_forward,
                  recurrent.init_mamba_cache)}[mixer]
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    layer = cls(cfg, torch.Generator(device=gpu).manual_seed(2), gpu)
    cpu = cls(cfg, None, "meta").to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    x = torch.randn((2, 1027, cfg.d_model), generator=torch.Generator().manual_seed(2))

    def run(p, dev):
        out, cache = fwd(x[:, :1024].to(dev), p, cfg, cache=init_cache(cfg, 2, dev))
        outs = [out]
        for t in range(1024, 1027):
            o, cache = fwd(x[:, t:t + 1].to(dev), p, cfg, cache=cache, decode=True)
            outs.append(o)
        return torch.cat(outs, dim=1).cpu(), {k: v.cpu() for k, v in cache.items()}

    with torch.no_grad():
        got, got_cache = run(layer, gpu)
        want, want_cache = run(cpu, "cpu")
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for name, w in want_cache.items():
        assert float((got_cache[name] - w).abs().max()) <= 1e-5 * float(w.abs().max()), name


def test_window_layer_on_cuda_matches_cpu(gpu, monkeypatch):
    """recurrentgemma's local attention on the smoke config in float32
    (TF32 off): a banded prefill of 2048 (band 544 of 2048 keys) and 40
    ring decode steps, outputs and ring within 1e-5 x max of the CPU's."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import attention

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(smoke_config("recurrentgemma-9b"), dtype="float32")
    W = cfg.sliding_window
    layer = attention.Attention(cfg, torch.Generator(device=gpu).manual_seed(3), gpu)
    cpu = attention.Attention(cfg, None, "meta").to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    x = torch.randn((2, 2088, cfg.d_model), generator=torch.Generator().manual_seed(3))

    def run(p, dev):
        out, ring = attention.gqa_forward(x[:, :2048].to(dev), p, cfg, window=W,
                                          cache=attention.init_gqa_cache(cfg, 2, 2048, W, dev))
        outs = [out]
        for t in range(2048, 2088):
            o, ring = attention.gqa_forward(x[:, t:t + 1].to(dev), p, cfg, window=W,
                                            cache=ring, decode=True,
                                            positions=torch.tensor([t], device=dev))
            outs.append(o)
        return torch.cat(outs, dim=1).cpu(), {k: v.cpu() for k, v in ring.items()}

    with torch.no_grad():
        got, got_ring = run(layer, gpu)
        want, want_ring = run(cpu, "cpu")
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got_ring["pos"], want_ring["pos"])
    for name in ("k", "v"):
        assert float((got_ring[name] - want_ring[name]).abs().max()) <= 1e-5 * float(
            want_ring[name].abs().max())
