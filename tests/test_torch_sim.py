"""Parity of the port's sim backend and its steps with ``repro``'s.

Splitters, the local sort and the tie fix, the merge tree, the six-step
``sample_sort_sim[_kv]``, the overflow ladder and the device decode, each
against its ``repro`` counterpart on the same numpy inputs, with exact
equality.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import keyenc as jkeyenc
from repro.core import local_sort as jlocal
from repro.core import merge as jmerge
from repro.core import overflow as joverflow
from repro.core import planner as jplanner
from repro.core import sim as jsim
from repro.core import splitters as jspl
from repro_torch.core import keyenc, local_sort, merge, overflow, planner, sim, splitters
from torch_parity import assert_bits_equal, jx, make_keys, port_config, port_np, tt

RNG = np.random.default_rng(11)


def _data(kind: str, shape, dtype="float32"):
    if kind == "uniform":
        return make_keys(RNG, shape, dtype)
    return make_keys(RNG, shape, dtype, distinct=4)  # the paper's duplicate-heavy case


@pytest.mark.parametrize("kind", ["uniform", "dup"])
@pytest.mark.parametrize("p,n", [(4, 1000), (5, 333)])
def test_splitters_and_bounds(kind, p, n):
    xs = np.sort(_data(kind, (p, n), "int32"), axis=-1)
    s = jspl.SortConfig().num_samples(p, n)
    want_samples = jax.vmap(lambda r: jspl.regular_sample(r, s))(jx(xs))
    samples = splitters.regular_sample(tt(xs), s)
    assert_bits_equal(want_samples, port_np(samples))
    want_spl = jspl.select_splitters(want_samples.reshape(-1), p)
    spl = splitters.select_splitters(samples.reshape(-1), p)
    assert_bits_equal(want_spl, port_np(spl))
    for jfn, fn in [(jspl.investigator_bounds, splitters.investigator_bounds),
                    (jspl.naive_bounds, splitters.naive_bounds)]:
        want = jax.vmap(jfn, in_axes=(0, None))(jx(xs), want_spl)
        got = fn(tt(xs), spl)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), port_np(got))


def test_sort_config_rules_match():
    for kw in [{}, {"capacity_factor": 0.5, "buffer_bytes": 100},
               {"samples_per_shard": 7}]:
        a, b = jspl.SortConfig(**kw), splitters.SortConfig(**kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for p, n, kb in [(8, 1 << 19, 4), (3, 10, 2), (16, 100, 1)]:
            assert a.num_samples(p, n, kb) == b.num_samples(p, n, kb)
            assert a.capacity(p, n) == b.capacity(p, n)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_local_sort_batched(use_pallas):
    x = _data("uniform", (4, 700))
    want = jax.vmap(lambda r: jlocal.local_sort(r, tile=128, use_pallas=use_pallas))(jx(x))
    assert_bits_equal(want, port_np(local_sort.local_sort(tt(x), tile=128,
                                                          use_pallas=use_pallas)))
    v = np.arange(x.size, dtype=np.int32).reshape(x.shape)
    wk, wv = jax.vmap(lambda k, vv: jlocal.local_sort_kv(k, vv, tile=128,
                                                         use_pallas=use_pallas))(jx(x), jx(v))
    ok, ov = local_sort.local_sort_kv(tt(x), tt(v), tile=128, use_pallas=use_pallas)
    assert_bits_equal(wk, port_np(ok))
    assert_bits_equal(wv, port_np(ov))


def test_segment_stable_kv_matches():
    keys = np.sort(_data("dup", 500, "int32"))
    vals = RNG.permutation(500).astype(np.int32)
    want = jlocal.segment_stable_kv(jx(keys), jx(vals))
    np.testing.assert_array_equal(np.asarray(want),
                                  port_np(local_sort.segment_stable_kv(tt(keys), tt(vals))))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("p,c", [(4, 100), (3, 64)])
def test_merge_padded_runs_batched(p, c, use_pallas):
    runs = np.sort(_data("dup", (2, p, c), "int32"), axis=-1)
    vals = RNG.integers(0, 1000, (2, p, c)).astype(np.int32)
    want = jax.vmap(lambda r: jmerge.merge_padded_runs(r, use_pallas=use_pallas))(jx(runs))
    got = merge.merge_padded_runs(tt(runs), use_pallas=use_pallas)
    assert_bits_equal(want, port_np(got))
    wk, wv = jax.vmap(lambda k, v: jmerge.merge_padded_runs_kv(
        k, v, use_pallas=use_pallas))(jx(runs), jx(vals))
    ok, ov = merge.merge_padded_runs_kv(tt(runs), tt(vals), use_pallas=use_pallas)
    assert_bits_equal(wk, port_np(ok))
    assert_bits_equal(wv, port_np(ov))


def _assert_sim_equal(want, got):
    for name in got._fields:
        w, g = getattr(want, name), getattr(got, name)
        assert_bits_equal(np.asarray(w), port_np(g)), name
    assert got.counts.dtype == got.send_counts.dtype == torch.int32


@pytest.mark.parametrize("investigator", [True, False])
@pytest.mark.parametrize("kind", ["uniform", "dup"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_sample_sort_sim(kind, investigator, use_pallas):
    x = _data(kind, (8, 512))
    cfg = jspl.SortConfig(tile=256, use_pallas=use_pallas, capacity_factor=4.0)
    want = jsim.sample_sort_sim(jx(x), cfg, investigator=investigator)
    got = sim.sample_sort_sim(tt(x), port_config(cfg), investigator=investigator)
    _assert_sim_equal(want, got)


@pytest.mark.parametrize("investigator", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_sample_sort_sim_kv(investigator, use_pallas):
    keys = _data("dup", (4, 1000), "int16")
    vals = np.arange(keys.size, dtype=np.int32).reshape(keys.shape)
    cfg = jspl.SortConfig(tile=256, use_pallas=use_pallas, capacity_factor=4.0)
    want = jsim.sample_sort_sim_kv(jx(keys), jx(vals), cfg, investigator=investigator)
    got = sim.sample_sort_sim_kv(tt(keys), tt(vals), port_config(cfg),
                                 investigator=investigator)
    _assert_sim_equal(want, got)


def test_sample_sort_sim_scatter_branch_above_8192():
    """n_local > 8192: the local merge tree's late rounds leave the bitonic
    kernel for the scatter merge, on the twin path as on CUDA."""
    x = _data("uniform", (2, 9000))
    cfg = jspl.SortConfig(tile=1024)
    _assert_sim_equal(jsim.sample_sort_sim(jx(x), cfg),
                      sim.sample_sort_sim(tt(x), port_config(cfg)))


def test_investigator_balances_duplicates():
    """Four distinct keys: plain sample sort sends each tied run to one
    destination (Fig. 3b); the investigator splits it (Fig. 3c)."""
    x = tt(_data("dup", (8, 2048), "int32"))
    cfg = splitters.SortConfig(use_pallas=False)
    inv = port_np(sim.sample_sort_sim(x, cfg).counts)
    naive = port_np(sim.sample_sort_sim(x, cfg, investigator=False).counts)
    assert inv.max() / inv.mean() < 1.05 < 1.5 < naive.max() / naive.mean()


@pytest.mark.parametrize("kv", [False, True])
def test_overflow_ladder_same_retries_and_final_config(kv):
    x = _data("dup", (8, 512), "int32")
    v = np.arange(x.size, dtype=np.int32).reshape(x.shape)
    cfg = jspl.SortConfig(capacity_factor=0.1, use_pallas=False)
    if kv:
        jrun = lambda c: jsim.sample_sort_sim_kv(jx(x), jx(v), c, investigator=False)
        prun = lambda c: sim.sample_sort_sim_kv(tt(x), tt(v), c, investigator=False)
    else:
        jrun = lambda c: jsim.sample_sort_sim(jx(x), c, investigator=False)
        prun = lambda c: sim.sample_sort_sim(tt(x), c, investigator=False)
    policy = dict(max_doublings=6, growth=2.0, raise_on_overflow=True)
    jres, jcfg, jretries = joverflow.run_with_capacity_retry(
        jrun, cfg, joverflow.OverflowPolicy(**policy))
    pres, pcfg, pretries = overflow.run_with_capacity_retry(
        prun, port_config(cfg), overflow.OverflowPolicy(**policy))
    assert jretries == pretries > 0
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    _assert_sim_equal(jres, pres)


def test_overflow_ladder_exhausted_raises_or_returns():
    x = _data("dup", (8, 512), "int32")
    run = lambda c: sim.sample_sort_sim(tt(x), c, investigator=False)
    cfg = splitters.SortConfig(capacity_factor=0.01, use_pallas=False)
    with pytest.raises(overflow.SortOverflowError):
        overflow.run_with_capacity_retry(run, cfg, overflow.OverflowPolicy(max_doublings=1))
    res, used, retries = overflow.run_with_capacity_retry(
        run, cfg, overflow.OverflowPolicy(max_doublings=2, raise_on_overflow=False))
    assert bool(res.overflowed) and retries == 2
    assert used.capacity_factor == pytest.approx(0.04)


@pytest.mark.parametrize("counts", [[5, 0, 7, 3], [9, 9, 9, 9], [0, 0, 12, 1]])
@pytest.mark.parametrize("m", [10, 20])
def test_compact_rows_clamps_like_dynamic_update_slice(counts, m):
    """Starts past m clamp to m; later rows overwrite earlier rows' pads."""
    grid = np.sort(RNG.integers(0, 50, (4, 9)), axis=-1).astype(np.int32)
    c = np.asarray(counts, np.int32)
    want = jkeyenc.compact_rows(jx(grid), jx(c), m)
    got = keyenc.compact_rows(tt(grid), tt(c), m)
    np.testing.assert_array_equal(np.asarray(want), port_np(got))


@pytest.mark.parametrize("descending", [False, True])
def test_decode_grid_matches_at_request_length(descending):
    """The port decodes exactly n elements; repro decodes a power-of-two
    bucket and slices n: the first n agree, tie fix included."""
    n, p = 3001, 8
    keys = _data("dup", n, "int32")
    per = -(-n // p)
    fill = np.iinfo(np.int32).max
    enc = ~keys if descending else keys
    grid = jplanner.pad_grid(enc, p, per, fill)
    pgrid = planner.pad_grid(tt(enc), p, per, fill)
    np.testing.assert_array_equal(grid, port_np(pgrid))
    prov = jplanner.pad_grid(np.arange(n, dtype=np.int32), p, per, fill)
    res = jsim.sample_sort_sim_kv(jx(grid), jx(prov), jspl.SortConfig(use_pallas=False))
    wk, wv = jkeyenc.decode_grid(res.keys, res.counts, res.values, m=4096,
                                 descending=descending, want_order=True)
    pk, pv = keyenc.decode_grid(tt(np.asarray(res.keys)), tt(np.asarray(res.counts)),
                                tt(np.asarray(res.values)), m=n, descending=descending,
                                want_order=True)
    np.testing.assert_array_equal(np.asarray(wk)[:n], port_np(pk))
    np.testing.assert_array_equal(np.asarray(wv)[:n], port_np(pv))
    np.testing.assert_array_equal(port_np(pv), np.argsort(enc, kind="stable"))
    np.testing.assert_array_equal(
        jplanner._trim_pad_counts(res.counts, p * per - n),
        planner._trim_pad_counts(np.asarray(res.counts), p * per - n))


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_unsigned_lanes_are_monotone_and_keep_the_sentinel(dtype):
    info = np.iinfo(dtype)
    x = np.array([0, 1, 7, info.max // 2, info.max // 2 + 1, info.max - 1, info.max], dtype)
    lane = keyenc.to_lane(tt(x))
    assert lane.dtype.is_signed and lane.element_size() == x.itemsize
    assert bool((lane[1:] > lane[:-1]).all())
    assert int(lane[-1]) == torch.iinfo(lane.dtype).max
    assert int(lane[0]) == torch.iinfo(lane.dtype).min
    assert_bits_equal(x, port_np(keyenc.from_lane(lane, tt(x).dtype)))
    flipped = keyenc.from_lane(keyenc.flip(lane), tt(x).dtype)
    assert_bits_equal(~x, port_np(flipped))
