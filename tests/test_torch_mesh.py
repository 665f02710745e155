"""The mesh backend of ``repro_torch`` against ``repro``'s, bit for bit.

``repro``'s side runs once per module in a subprocess on 8 virtual host
devices (tests/torch_mesh_reference.py: ``jax.make_mesh((4, 2), ("data",
"model"))``, every output read through ``np.asarray`` and the host
decode). The port's side is 8 gloo processes on the CPU
(tests/torch_mesh_worker.py, one ``DeviceMesh("cpu", (4, 2))``), started
at the same time, each sorting its own ``pad_grid`` shard of the same
seeded cases (tests/torch_mesh_cases.py) with both decodes. Both sides
rendezvous through files, so no port is taken; the ranks join with a
timeout and are killed past it.

Each rank's block, concatenated in coordinate order, must equal
``repro``'s keys, values and order; counts, send counts, the overflow
flag and the ladder's retries must equal ``repro``'s on every rank; each
rank's raw row must equal its row of ``repro``'s grid; ranks that share
the group's coordinates (the other "model" column) must return the same.
Tuples (the ``mk_*`` cases) are held the same way, for both of the port's
decodes; a shard that makes the sort refuse a tuple makes every rank
raise. int64 sorts in x64 mode, and an int64 pair packed into 63 bits, are
held to the port's own sim on the same grid (tests/test_torch_x64.py holds
that sim to ``repro``). The error paths and a tuple over a one-rank mesh
run in this process.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import sim
from repro_torch.sharding import spec
from torch_parity import assert_bits_equal, run_mesh_sides, world_mesh
import torch_mesh_cases as C

CASES = C.cases()
LIBRARY = C.library_cases()
DECODES = ("device", "host")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(repro's npz, the port's npz per global rank)."""
    return run_mesh_sides(tmp_path_factory.mktemp("mesh"), C.WORLD)


def group(axis, column: int = 0) -> list:
    """Global ranks of the axis group holding global rank ``column``, in
    coordinate order."""
    members = [r for r in range(C.WORLD)
               if all(np.unravel_index(r, C.MESH_SHAPE)[d] == np.unravel_index(column,
                                                                             C.MESH_SHAPE)[d]
                      for d, a in enumerate(C.MESH_AXES)
                      if a not in (axis if isinstance(axis, tuple) else (axis,)))]
    return sorted(members, key=lambda r: C.axis_coord(r, axis))


def key_columns(d: dict, key: str) -> list:
    """The key columns saved under ``key``: one array, or a tuple's."""
    if f"{key}/keys" in d:
        return [d[f"{key}/keys"]]
    return [d[f"{key}/keys/{j}"] for j in range(len(d)) if f"{key}/keys/{j}" in d]


@pytest.mark.parametrize("decode", DECODES)
@pytest.mark.parametrize("name", list(CASES))
def test_blocks_equal_repro(both, name, decode):
    """Single keys and tuples (``mk_*``: packed and LSD, ``repro`` under
    its host decode) alike."""
    ref, ranks = both
    axis = CASES[name]["axis"]
    key = f"{name}/{decode}"
    n = C.n_of(CASES[name])
    want_cols = key_columns(ref, name)
    assert len(want_cols) == (len(CASES[name]["keys"]) if name.startswith("mk_") else 1)
    for column in (0, 1):
        members = group(axis, column)
        for j, want in enumerate(want_cols):
            keys = np.concatenate([key_columns(ranks[r], key)[j] for r in members])
            assert_bits_equal(keys, want)
        if f"{name}/values" in ref:
            vals = np.concatenate([ranks[r][f"{key}/values"] for r in members])
            assert_bits_equal(vals, ref[f"{name}/values"])
        start = 0
        for i, r in enumerate(members):
            got = ranks[r]
            index, size, b0, b1 = got[f"{key}/block"]
            assert (index, size, b0) == (i, len(members), start)
            assert all(b1 - b0 == c.shape[0] for c in key_columns(got, key))
            start = b1
            for field in ("counts", "send_counts", "retries", "overflowed"):
                assert (f"{key}/{field}" in got) == (f"{name}/{field}" in ref), field
                if f"{name}/{field}" in ref:
                    np.testing.assert_array_equal(got[f"{key}/{field}"],
                                                  ref[f"{name}/{field}"])
            assert got[f"{key}/n"] == n
        assert start == n


@pytest.mark.parametrize("name", [*CASES, *LIBRARY])
def test_raw_rows_equal_repro(both, name):
    """Each rank's ``.raw`` is its row of repro's grid (the sort's, and
    ``SortLibrary.distributed_sort[_kv]``'s with no retry)."""
    ref, ranks = both
    axis = (CASES.get(name) or LIBRARY[name])["axis"]
    keys = [f"{name}/device", f"{name}/host"] if name in CASES else [name]
    for key in keys:
        for i, r in enumerate(group(axis, 0) + group(axis, 1)):
            row = i % C.axis_size(axis)
            for field in ("raw_values", "raw_keys", "raw_count", "raw_send_counts",
                          "raw_overflowed"):
                if f"{name}/{field}" in ref:
                    assert_bits_equal(ranks[r][f"{key}/{field}"], ref[f"{name}/{field}"][row])
    if name == "lib_overflow":
        assert ref[f"{name}/raw_overflowed"].all()


@pytest.mark.parametrize("name", ["uniform", "kv10_pod", "dup3"])
def test_distributed_sort_entry_points_equal_repro(both, name):
    """``distributed_sort`` (uniform), ``distributed_sort_kv`` (kv10_pod)
    and ``distributed_sort_phased`` (dup3) called directly: this rank's row
    of repro's grid."""
    ref, ranks = both
    axis = CASES[name]["axis"]
    for i, r in enumerate(group(axis, 0) + group(axis, 1)):
        row = i % C.axis_size(axis)
        for field in ("raw_values", "raw_keys", "raw_count", "raw_send_counts"):
            if f"{name}/{field}" in ref:
                assert_bits_equal(ranks[r][f"direct/{name}/{field}"], ref[f"{name}/{field}"][row])


def test_library_refuses_unequal_shards_on_every_rank(both):
    _, ranks = both
    errors = {str(g["lib_unequal/error"]) for g in ranks}
    assert len(errors) == 1
    assert "input length 8003 does not divide the 4-way sort axis" in errors.pop()


def test_ladder_retries_in_lockstep(both):
    """Only coordinate 0 overflows on its own; the reduced flag is True on
    every rank, and every rank takes repro's ladder steps together."""
    ref, ranks = both
    members = group("data", 0) + group("data", 1)
    local = [bool(ranks[r]["lockstep/local_overflow"]) for r in members]
    assert local == [True, False, False, False] * 2
    assert all(bool(ranks[r]["lockstep/reduced_overflow"]) for r in members)
    assert int(ref["lockstep/retries"]) == 2 and int(ref["ladder/retries"]) >= 1
    for name in ("lockstep", "ladder"):
        for r in members:
            for decode in DECODES:
                assert ranks[r][f"{name}/{decode}/retries"] == ref[f"{name}/retries"]


@pytest.mark.parametrize("decode", DECODES)
def test_traced_phases_equal_repro(both, decode):
    ref, ranks = both
    names = list(ref["traced/names"]) + (["d2h"] if decode == "device" else [])
    members = group("data", 0)
    for r in members:
        got = ranks[r]
        assert list(got[f"traced/{decode}/names"]) == names
        for k in ref:
            if k.startswith("traced/") and k.count("/") == 2:
                phase = k.split("/", 1)[1]
                np.testing.assert_array_equal(got[f"traced/{decode}/{phase}"], ref[k])
    keys = np.concatenate([ranks[r][f"traced/{decode}/keys"] for r in members])
    assert_bits_equal(keys, ref["traced/keys"])


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_topk_shard_equals_repro(both, dtype, largest):
    ref, ranks = both
    for got in ranks:
        for part in ("values", "indices"):
            assert_bits_equal(got[f"topk/{dtype}/{largest}/{part}"],
                              ref[f"topk/{dtype}/{largest}/{part}"])


def test_vocab_pad_over_the_mesh_equals_repro(both):
    ref, ranks = both
    for k in (k for k in ref if k.startswith("vocab_pad/")):
        assert all(got[k] == ref[k] for got in ranks)


@pytest.mark.parametrize("want", ["values", "order"])
def test_x64_blocks_equal_the_sim(both, want):
    """int64 keys in x64 mode: the ranks' blocks, counts and send counts
    equal the port's sim over the same (4, 2048) grid."""
    _, ranks = both
    x = np.random.default_rng(25).integers(-(1 << 40), 1 << 40, 8192) >> 38
    with repro_torch.x64_mode():
        want_out = repro_torch.sort(x, want=want, device="cpu", where="sim",
                                    config=repro_torch.SortConfig(tile=256),
                                    limits=repro_torch.SortLimits(n_procs=4))
    members = group("data", 0)
    keys = np.concatenate([ranks[r][f"x64/{want}/keys"] for r in members])
    assert keys.dtype == np.int64
    np.testing.assert_array_equal(keys, want_out.keys.numpy())
    if want == "order":
        np.testing.assert_array_equal(
            np.concatenate([ranks[r][f"x64/{want}/values"] for r in members]),
            want_out.values.numpy())
    for r in members:
        np.testing.assert_array_equal(ranks[r][f"x64/{want}/counts"], want_out.counts)
        np.testing.assert_array_equal(ranks[r][f"x64/{want}/send_counts"],
                                      want_out.send_counts)


# ------------------------------------------------ one rank, in this process


def test_one_rank_mesh_equals_the_sim():
    mesh = world_mesh()
    x = np.random.default_rng(26).integers(0, 9, 3000).astype(np.int32)
    for kw in ({}, {"want": "order"}, {"order": "desc"}):
        got = repro_torch.sort(x, where=mesh, device="cpu", **kw)
        want = repro_torch.sort(x, where="sim", device="cpu", **kw,
                                limits=repro_torch.SortLimits(n_procs=1))
        assert got.block == (0, 1, 0, 3000)
        assert got.meta.backend == "mesh" and got.meta.plan.n_procs == 1
        np.testing.assert_array_equal(got.keys.numpy(), want.keys.numpy())
        if "want" in kw:
            np.testing.assert_array_equal(got.order().numpy(), want.order().numpy())
        np.testing.assert_array_equal(got.counts, want.counts)
        np.testing.assert_array_equal(got.send_counts, want.send_counts)
    with pytest.raises(ValueError, match="block 0 of 1"):
        got.topk(3)


def test_mesh_without_a_mesh_raises_repros_error():
    with pytest.raises(ValueError, match='backend "mesh" needs where=<Mesh> or'):
        repro_torch.sort(np.arange(10, dtype=np.int32), where="mesh", device="cpu")


def test_where_that_is_not_a_mesh_raises():
    with pytest.raises(TypeError, match="DeviceMesh"):
        repro_torch.sort(np.arange(10, dtype=np.int32), where=object(), device="cpu")


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cpu_mesh_refuses_a_cuda_sort(device):
    with pytest.raises(ValueError, match="pass device='cpu'"):
        repro_torch.sort(np.arange(10, dtype=np.int32), where=(world_mesh(), "data"),
                         device=device)


@pytest.mark.parametrize("kw", [{}, {"want": "order"}, {"values": True}])
@pytest.mark.parametrize("limits", [{}, {"multikey": "lsd"}, {"decode": "host"}])
def test_multikey_on_one_rank_mesh_equals_the_sim(limits, kw):
    """A tuple over a one-rank mesh: packed (or LSD) on the one rank, its
    blocks, counts and retries the sim's (n_procs=1)."""
    rng = np.random.default_rng(30)
    k = (rng.integers(0, 4, 3000).astype(np.int32), rng.integers(0, 90, 3000).astype(np.int16))
    kw = dict(kw)
    if kw.pop("values", False):
        kw["values"] = rng.uniform(size=3000).astype(np.float32)
    got = repro_torch.sort(k, where=(world_mesh(), "data"), device="cpu", order=("desc", "asc"),
                           limits=repro_torch.SortLimits(**limits), **kw)
    want = repro_torch.sort(k, where="sim", device="cpu", order=("desc", "asc"),
                            limits=repro_torch.SortLimits(n_procs=1, **limits), **kw)
    expect = "lsd" if limits.get("multikey") == "lsd" else "packed"
    assert got.meta.multikey == want.meta.multikey == expect
    # indexed exchanges: LSD re-blocks once and takes the key, the
    # permutation and the results; a packed sort takes only a payload
    assert got.meta.exchanges == ({"reblock": 1, "take": 3} if expect == "lsd"
                                  else {"take": 1} if "values" in kw else {})
    assert want.meta.exchanges is None
    assert got.block == (0, 1, 0, 3000)
    for a, b in zip(got.keys, want.keys, strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if want.values is not None:
        np.testing.assert_array_equal(got.values.numpy(), want.values.numpy())
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.meta.retries == want.meta.retries


def test_key_bits_violation_on_one_rank_raises_on_every_rank(both):
    """Coordinate 2's shard holds a value past its declared width: every
    rank raises ``repro``'s ValueError, naming that value."""
    ref, ranks = both
    assert "value np.int32(21) does not fit" in str(ref["error/key_bits"])
    assert [str(g.get("error/key_bits")) for g in ranks] == [str(ref["error/key_bits"])] * C.WORLD


def test_nan_in_one_shard_of_an_lsd_pass_raises_on_every_rank(both):
    """A NaN in coordinate 1's shard of a float column that runs LSD: the
    pass's payload sort refuses it on every rank with the same text, as
    ``repro`` refuses the global array."""
    ref, ranks = both
    assert "cannot contain NaN keys" in str(ref["error/nan"])
    errors = {str(g.get("error/nan")) for g in ranks}
    assert len(errors) == 1 and "refused on rank(s) [1] of the axis group" in errors.pop()


@pytest.mark.parametrize("want", ["values", "order"])
def test_x64_pair_blocks_equal_the_sim(both, want):
    """An int64 pair over 63 bits in x64 mode: one int64 packed sort over
    the mesh, its blocks, counts and send counts the port's sim's over the
    same (4, 2048) grid."""
    _, ranks = both
    pair = C.x64_pair()
    with repro_torch.x64_mode():
        want_out = repro_torch.sort(pair, want=want, order=("desc", "asc"), device="cpu",
                                    where="sim", config=repro_torch.SortConfig(tile=256),
                                    limits=repro_torch.SortLimits(n_procs=4))
    assert want_out.meta.plan.packspec.pack_dtype == torch.int64
    members = group("data", 0)
    for j, col in enumerate(want_out.keys):
        keys = np.concatenate([ranks[r][f"x64_pair/{want}/keys/{j}"] for r in members])
        np.testing.assert_array_equal(keys, col.numpy())
    if want == "order":
        np.testing.assert_array_equal(
            np.concatenate([ranks[r][f"x64_pair/{want}/values"] for r in members]),
            want_out.values.numpy())
    for r in members:
        assert str(ranks[r][f"x64_pair/{want}/multikey"]) == "packed"
        np.testing.assert_array_equal(ranks[r][f"x64_pair/{want}/counts"], want_out.counts)
        np.testing.assert_array_equal(ranks[r][f"x64_pair/{want}/send_counts"],
                                      want_out.send_counts)


def test_axis_group_of_a_tuple_follows_the_mesh_order():
    mesh = world_mesh()
    ag = spec.axis_group(mesh, ("data",))
    assert (ag.size, ag.index, ag.ranks) == (1, 0, (0,))
    assert spec.axis_size(mesh, "data") == 1 and spec.axis_index(mesh, ("data",)) == 0
    with pytest.raises(ValueError, match="no axis 'model'"):
        spec.axis_group(mesh, "model")
    assert spec.from_mesh(mesh).batch == ("data",) and spec.from_mesh(None) is None
    assert sim._gather_buckets(torch.arange(6)[None], torch.tensor([[0, 2, 6]]), 4).shape \
        == (1, 2, 4)
