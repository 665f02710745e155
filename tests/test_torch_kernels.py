"""Parity of the port's sorting kernels with ``repro``'s, on the CPU.

Each plain twin of ``repro_torch.kernels.bitonic`` is held against the
Pallas kernel of ``repro.kernels.bitonic`` in interpret mode, then the
dispatch layer (``ops``) against ``repro.kernels.ops``, all with exact
equality: the same compare-exchange network gives the same output, down
to which of two tied keys (+0.0 and -0.0, or equal keys with different
values) lands where.
"""
import re

import numpy as np
import pytest
import torch

from repro.kernels import bitonic as jbitonic
from repro.kernels import ops as jops
from repro_torch.kernels import bitonic, build, ops, ref
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


def _sorted_keys(rows, n, dtype, distinct=None):
    """Sorted rows; dtype "special": float32 with +-0.0, +-inf and NaN
    (``_special_keys``; np.sort puts NaN last)."""
    if dtype == "special":
        return np.sort(_special_keys(RNG, rows, n, "float32"), axis=-1)
    return _sorted_rows(rows, n, dtype, distinct)


@pytest.mark.parametrize("rows,n", [(1, 1), (2, 128), (8, 4096)])
@pytest.mark.parametrize("dtype", ["float32", "int32", "uint32", "special"])
def test_merge_twin_matches_pallas(rows, n, dtype):
    a, b = _sorted_keys(rows, n, dtype), _sorted_keys(rows, n, dtype)
    want = jbitonic.bitonic_merge_rows(jx(a), jx(b), interpret=True)
    assert_bits_equal(want, port_np(bitonic.bitonic_merge_rows(tt(a), tt(b))))


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("kdtype,vdtype", [("float32", "int32"), ("int32", "uint32"),
                                           ("special", "int32")])
def test_merge_kv_twin_matches_pallas(kdtype, vdtype, stable):
    ak, bk = _sorted_keys(4, 128, kdtype, 6), _sorted_keys(4, 128, kdtype, 6)
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
        bitonic.bitonic_sort_rows(torch.zeros((2, 8), dtype=torch.complex64))


def test_cpu_twins_count_no_launches():
    bitonic.reset_launches()
    k = tt(_rows(2, 64, "float32"))
    bitonic.bitonic_sort_rows(k)
    bitonic.bitonic_merge_rows(k[:, :32].sort().values, k[:, 32:].sort().values)
    assert all(fn.launches == 0 for fn in bitonic.KERNELS)


# ----------------------------------------------- the row-sort kernel's layout


def _sort_layout() -> dict:
    """The row-sort kernel's layout constants, read from csrc/bitonic.cu;
    bitonic.py's mirror of the layout (sort_elems, sort_threads) must use
    the same constants and the same rules."""
    src = (build.CSRC / "bitonic.cu").read_text()
    const = {name: int(val) for name, val in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert "return (1 << log_n) / kElems > kMaxThreads ? kLogElems + 1 : kLogElems;" in src
    assert "return cmax((1 << log_n) >> log_elems(log_n), kMinThreads);" in src  # threads
    assert "constexpr bool kCta = HI >= LE + kLogWarp;" in src
    assert "return a ^ (((x ^ (x << 1)) & 7) << 2);" in src  # swz
    assert 1 << const["kLogElems"] == const["kElems"] and 1 << const["kLogWarp"] == const["kWarp"]
    assert 1 << const["kLogMaxRow"] == bitonic.MAX_ROW
    assert (bitonic.SORT_ELEMS, bitonic.SORT_MIN_THREADS, bitonic.SORT_MAX_THREADS) == (
        const["kElems"], const["kMinThreads"], const["kMaxThreads"])
    return const


def _swz(a):
    """csrc/bitonic.cu's swz: the shared-memory word of CTA-flat index a."""
    x = (a >> 5) & 7
    return a ^ (((x ^ (x << 1)) & 7) << 2)


def _bank_ways(words, lanes: int = 32, width: int = 1) -> int:
    """The most distinct shared-memory words (of ``width`` 4-byte words
    each) that ``lanes`` threads reading ``words`` (one per thread, in
    thread order) at once send to one bank."""
    worst = 1
    for start in range(0, len(words), lanes):
        by_bank = {}
        for w in words[start:start + lanes]:
            by_bank.setdefault(w % 32 // width, set()).add(w)
        worst = max(worst, *map(len, by_bank.values()))
    return worst


def _flip_if(x, on):
    """flip_if: float32 by the sign bit, int32 (and uint32 as the twin's
    signed lanes) by all bits; ``on`` broadcasts over x."""
    mask = -(1 << 31) if x.dtype == torch.float32 else -1
    bits = x.view(torch.int32) ^ torch.where(on, mask, 0).to(torch.int32)
    return bits.view(x.dtype)


def _out_of_order(asc, a, b, va, vb):
    """The kernel's out_of_order on tensors; ``va`` None: no tie-break."""
    gt, lt = a > b, a < b
    if va is not None:
        eq = a == b
        gt, lt = gt | (eq & (va > vb)), lt | (eq & (va < vb))
    return torch.where(asc, gt, lt)


def _reg_stage(k, v, asc, bit: int, tiebreak: bool):
    """cmpx_regs: register r against r + 2^bit, in the direction asc[..., r]."""
    lo = [r for r in range(k.shape[-1]) if not r & (1 << bit)]
    hi = [r + (1 << bit) for r in lo]
    a, b = k[..., lo], k[..., hi]
    va, vb = (v[..., lo], v[..., hi]) if v is not None else (None, None)
    swap = _out_of_order(asc[..., lo], a, b, va if tiebreak else None, vb)
    k = k.clone()
    k[..., lo], k[..., hi] = torch.where(swap, b, a), torch.where(swap, a, b)
    if v is not None:
        v = v.clone()
        v[..., lo], v[..., hi] = torch.where(swap, vb, va), torch.where(swap, va, vb)
    return k, v


def _cta_shape(n: int) -> tuple[int, int]:
    """(threads, elements a thread) of a row-sort or merge CTA for rows of n."""
    return bitonic.sort_threads(n), bitonic.sort_elems(n)


def _emulate_row_sort(keys, values, tiebreak: bool, const: dict):
    """sort_rows_kernel's schedule in PyTorch: registers as a (CTAs,
    threads, kElems) tensor loaded from consecutive elements, then every
    phase (``_emulate_phases``)."""
    rows, n = keys.shape
    T, E = _cta_shape(n)
    ctas = -(-rows // (T * E // n))
    pad = ctas * (T * E // n) - rows  # a short last CTA reads zeros past the last row

    def regs(x):
        x = torch.cat([x, x.new_zeros((pad, n))]) if pad else x
        return x.reshape(ctas, T, E)

    v = regs(values) if values is not None else None
    k, v = _emulate_phases(regs(keys), v, n, range(n.bit_length() - 1), tiebreak, const)
    k = k.reshape(-1, n)[:rows]
    return k if v is None else (k, v.reshape(-1, n)[:rows])


def _emulate_phases(k, v, n: int, phases, tiebreak: bool, const: dict):
    """sort_phase over registers k, v (CTAs, threads, E) holding rows of n,
    for each phase in ``phases``: the phases' flips of descending blocks;
    the longer distances as gathers of whole butterflies from the swizzled
    shared-memory image (the CTA's in turn, or the warp's own); the
    direction of the first phases from the register index."""
    log_n = n.bit_length() - 1
    ctas, T, E = k.shape
    warp = const["kWarp"]
    log_e = E.bit_length() - 1
    log_warp_span = log_e + const["kLogWarp"]
    B = T * E
    assert torch.equal(_swz(torch.arange(B)).sort().values, torch.arange(B))
    t = torch.arange(T)
    f0 = t * E
    own = _swz(f0[:, None] + torch.arange(E))  # (T, E) words of each thread's elements
    if E == 8:  # 16-byte pieces go 8 threads at a time
        assert all(_bank_ways(own[:, i].tolist(), 8, 4) == 1 for i in range(0, E, 4))
    flip = torch.zeros(T, dtype=torch.bool)
    for s in phases:
        span, whole = 2 << s, s == log_n - 1
        if span < E:  # a direction per register pair
            asc = (whole | ((torch.arange(E) & span) == 0)).expand(T, E)
        else:  # flip descending blocks, then compare ascending
            want = ((f0 & span) != 0) & (not whole)
            k = _flip_if(k, (want != flip)[None, :, None])
            if tiebreak:
                v = _flip_if(v, (want != flip)[None, :, None])
            flip = want
            asc = torch.ones(T, E, dtype=torch.bool)
        if s >= log_e:  # through shared memory
            sk = k.new_zeros(ctas, B)
            sk[:, own.flatten()] = k.reshape(ctas, B)
            sv = None
            if v is not None:
                sv = v.new_zeros(ctas, B)
                sv[:, own.flatten()] = v.reshape(ctas, B)
            hi = s
            while hi >= log_e:
                lo = max(hi - log_e + 1, log_e)
                g = hi - lo + 1
                i = torch.arange(E >> g)[None, :]
                if hi >= log_warp_span:  # the CTA's butterflies in turn
                    q = t[:, None] + i * T
                else:  # the warp's own butterflies
                    q = (t >> 5)[:, None] * (warp * E >> g) + (t & (warp - 1))[:, None] + i * warp
                base = ((q >> lo) << (lo + g)) | (q & ((1 << lo) - 1))
                flat = (base[..., None] + (torch.arange(1 << g) << lo)).reshape(T, E)
                if hi < log_warp_span:
                    assert torch.equal(flat // (warp * E), (t // warp)[:, None].expand(T, E))
                idx = _swz(flat)
                assert torch.equal(idx.flatten().sort().values, torch.arange(B))
                if E == 8:  # swz leaves no bank conflict in any group
                    assert all(_bank_ways(idx[:, r].tolist()) == 1 for r in range(E))
                bk = sk[:, idx]
                bv = sv[:, idx] if sv is not None else None
                for bit in range(g - 1, -1, -1):
                    bk, bv = _reg_stage(bk, bv, torch.ones(T, E, dtype=torch.bool), bit,
                                        tiebreak)
                sk = sk.clone()
                sk[:, idx.flatten()] = bk.reshape(ctas, B)
                if sv is not None:
                    sv = sv.clone()
                    sv[:, idx.flatten()] = bv.reshape(ctas, B)
                hi = lo - 1
            k = sk[:, own]
            v = sv[:, own] if sv is not None else None
        for bit in range(min(s, log_e - 1), -1, -1):  # register bits
            k, v = _reg_stage(k, v, asc, bit, tiebreak)
    assert not flip.any()
    return k, v


def _emulate_merge_load(a, b):
    """merge_rows_kernel's load into (CTAs, threads, E) registers: thread t
    of CTA c holds the E elements of a ++ reverse(b) from flat index
    g0 = (c T + t) E on; where E divides n they are one 16-byte-aligned
    piece of a row of a, or of b read backwards, else element by element;
    past the last row, zeros."""
    rows, n = a.shape
    T, E = _cta_shape(2 * n)
    ctas = -(-rows * 2 * n // (T * E))
    g = (torch.arange(ctas * T) * E)[:, None] + torch.arange(E)
    row, p = g // (2 * n), g % (2 * n)
    live = row < rows
    row = row.clamp(max=rows - 1)
    from_b = p >= n
    if n % E == 0:  # one piece: its start, in a or in b, and its direction
        p0 = p[:, :1]
        assert torch.equal(from_b, (p0 >= n).expand_as(p))
        start = torch.where(p0 >= n, 2 * n - E - p0, p0)
        assert not (start % 4).any()  # 16-byte loads from 16-byte-aligned rows
        piece = start + torch.arange(E)
        got = torch.where(from_b, b[row, piece], a[row, piece])
        x = torch.where(from_b, got.flip(-1), got)
    else:
        x = torch.where(from_b, b[row, (2 * n - 1 - p).clamp(max=n - 1)],
                        a[row, p.clamp(max=n - 1)])
    return torch.where(live, x, torch.zeros_like(x)).reshape(ctas, T, E)


def _emulate_merge(a, b, av, bv, tiebreak: bool, const: dict):
    """merge_rows_kernel's schedule: the reversed load, then the row sort's
    last phase alone on rows of 2n."""
    rows, n = a.shape
    k = _emulate_merge_load(a, b)
    v = _emulate_merge_load(av, bv) if av is not None else None
    log_n2 = n.bit_length()
    k, v = _emulate_phases(k, v, 2 * n, [log_n2 - 1], tiebreak, const)
    k = k.reshape(-1, 2 * n)[:rows]
    return k if v is None else (k, v.reshape(-1, 2 * n)[:rows])


def _special_keys(rng, rows, n, dtype):
    """Heavy duplicates, with +-0.0, +-inf and NaN among float keys."""
    x = rng.integers(-3, 4, (rows, n))
    if dtype != "float32":
        info = np.iinfo(dtype)
        return np.where(x == 3, info.max, np.where(x == -3, info.min, x)).astype(dtype)
    f = x.astype(np.float32)
    f[x == 0] = np.where(rng.random((x == 0).sum()) < 0.5, 0.0, -0.0)
    f[x == 3] = np.inf
    f[x == -3] = -np.inf
    f[(x == 2) & (rng.random(x.shape) < 0.5)] = np.nan
    return f


@pytest.mark.parametrize("case", ["keys float32", "keys uint32", "kv float32/int32 stable",
                                  "kv float32/float32", "kv int32/uint32 stable",
                                  "kv uint32/float32 stable"])
@pytest.mark.parametrize("n", [1 << e for e in range(1, 14)])
def test_register_layout_runs_the_network(n, case):
    """The kernel's layout (registers, flipped descending blocks,
    swizzled shared-memory butterflies of the CTA or of the warp, a short
    last CTA) runs the same network as sort_rows_twin, bit for bit, and
    at 8 keys a thread no shared-memory access has a bank conflict."""
    const = _sort_layout()
    rng = np.random.default_rng(n)
    rows_per_cta = bitonic.sort_rows_per_cta(n)
    rows = rows_per_cta + 1 if rows_per_cta > 1 else 3
    types = case.split()[1].split("/")
    k = bitonic._signed(tt(_special_keys(rng, rows, n, types[0])))
    if len(types) == 1:
        got, want = _emulate_row_sort(k, None, False, const), bitonic.sort_rows_twin(k)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        return
    stable = case.endswith("stable")
    v = bitonic._signed(tt(_special_keys(rng, rows, n, types[1])))
    got = _emulate_row_sort(k, v, stable, const)
    want = bitonic.sort_rows_twin(k, v, stable=stable)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("case", ["keys float32", "keys int32", "kv float32/int32",
                                  "kv float32/int32 stable", "kv uint32/float32 stable"])
@pytest.mark.parametrize("n2", [1 << e for e in range(1, 14)])
def test_merge_layout_runs_the_network(n2, case):
    """merge_rows_kernel's layout (the reversed load of a ++ reverse(b) as
    16-byte pieces or element by element, a short last CTA, then the row
    sort's last phase alone: swizzled butterflies of the CTA or of the
    warp, no flips) runs the same network as merge_rows_twin, bit for bit."""
    const = _sort_layout()
    rng = np.random.default_rng(n2 + 1)
    per_cta = bitonic.sort_rows_per_cta(n2)
    rows = per_cta + 1 if per_cta > 1 else 3
    types = case.split()[1].split("/")

    def sorted_rows(dtype):
        return bitonic.sort_rows_twin(bitonic._signed(tt(_special_keys(rng, rows, n2 // 2,
                                                                       dtype))))

    a, b = sorted_rows(types[0]), sorted_rows(types[0])
    if len(types) == 1:
        got, want = _emulate_merge(a, b, None, None, False, const), bitonic.merge_rows_twin(a, b)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        return
    stable = case.endswith("stable")
    av, bv = (bitonic._signed(tt(_special_keys(rng, rows, n2 // 2, types[1]))) for _ in "ab")
    got = _emulate_merge(a, b, av, bv, stable, const)
    want = bitonic.merge_rows_twin(a, b, av, bv, stable=stable)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _search_rows(rng, rows, n, kind):
    """Rows to search in: sorted, or with NaN (unsorted after it, as the
    exchange's +inf pads and the bitonic network leave them), +-0.0 and
    +-inf; integer rows sorted."""
    if kind == "int32":
        return np.sort(rng.integers(-20, 20, (rows, n)).astype(np.int32), axis=1)
    x = rng.integers(-6, 6, (rows, n)).astype(np.float32)
    x[x == 0] = np.where(rng.random((x == 0).sum()) < 0.5, 0.0, -0.0)
    x[x == 5] = np.inf
    x[x == -6] = -np.inf
    x = np.sort(x, axis=1)
    if kind == "nan":
        x[rng.random(x.shape) < 0.1] = np.nan
        x[:, -3:] = np.inf
    return x


@pytest.mark.parametrize("kind", ["sorted float32", "nan", "int32"])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_jax_searchsorted_equals_jnp_searchsorted(n, kind):
    """Probe for probe, on sorted rows and on rows a NaN left unsorted."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    rows = _search_rows(rng, 3, n, kind)
    queries = _search_rows(rng, 3, 50, kind)[:, rng.permutation(50)]
    for side in ("left", "right"):
        want = jax.vmap(lambda r, q: jnp.searchsorted(r, q, side=side))(rows, queries)
        got = ops.jax_searchsorted(tt(rows), tt(queries), side)
        np.testing.assert_array_equal(port_np(got), np.asarray(want))
        if kind != "nan":
            np.testing.assert_array_equal(
                port_np(got), port_np(torch.searchsorted(tt(rows), tt(queries), side=side)))


@pytest.mark.parametrize("n", [9000, 20000])
def test_rank_merge_on_nan_rows_equals_repro(n):
    """The rank merge a NaN sort takes (ops.rank_functions(True)) on rows a
    NaN left unsorted: colliding ranks keep the writer XLA's CPU scatter
    keeps (b over a, the higher index within one), holes stay 0. Payload
    sorts refuse NaN keys, so only the keys-only merge has this path."""
    rng = np.random.default_rng(n)
    a, b = _search_rows(rng, 2, n, "nan"), _search_rows(rng, 2, n, "nan")
    search, wide_merge = ops.rank_functions(True)
    assert search is ops.jax_searchsorted
    want = jops._scatter_merge(jx(a), jx(b))
    assert_bits_equal(want, port_np(wide_merge(tt(a), tt(b))))
    assert_bits_equal(want, port_np(ops.merge_rows(tt(a), tt(b), wide_merge=wide_merge)))
