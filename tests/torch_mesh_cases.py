"""The seeded cases of tests/test_torch_mesh.py, shared by ``repro``'s side
(tests/torch_mesh_reference.py) and the port's ranks
(tests/torch_mesh_worker.py). numpy only: each side imports this and its
own package. A case's keys are one array or a tuple of key columns (a
lexicographic sort); each column is sharded alike.

The mesh is (4, 2) with axes ("data", "model"), as in
tests/test_distributed.py. A case names its global keys, payload, sort
axis, ``SortConfig`` and ``SortLimits`` fields and keyword arguments; the
port's rank at coordinate r of the axis takes ``shard(x, p, r)``, the
slice ``planner.pad_grid`` gives row r.

The MoE cases (tests/test_torch_moe_mesh.py) run on a (2, 4) mesh, as
tests/test_distributed.py's MoE test does: ``moe_inputs()`` gives the
weights of one MoE layer at the smoke deepseek-moe-16b widths and the
global tokens, ``moe_cases()`` the expert axes and config fields.
"""
from __future__ import annotations

import numpy as np

MESH_SHAPE = (4, 2)
MESH_AXES = ("data", "model")
WORLD = MESH_SHAPE[0] * MESH_SHAPE[1]

TOPK_K = 7


def axis_size(axis) -> int:
    axes = axis if isinstance(axis, tuple) else (axis,)
    return int(np.prod([MESH_SHAPE[MESH_AXES.index(a)] for a in axes]))


def axis_coord(rank: int, axis) -> int:
    """The coordinate along ``axis`` of global rank ``rank`` (mesh ranks
    laid out row-major, as ``DeviceMesh(torch.arange(8).reshape(4, 2))``)."""
    coord = np.unravel_index(rank, MESH_SHAPE)
    axes = axis if isinstance(axis, tuple) else (axis,)
    idx = 0
    for a in axes:
        d = MESH_AXES.index(a)
        idx = idx * MESH_SHAPE[d] + int(coord[d])
    return idx


def shard(x: np.ndarray, p: int, r: int) -> np.ndarray:
    """Row r of ``pad_grid``'s split of ``x`` over p rows, unpadded."""
    base, extra = divmod(x.shape[0], p)
    start = r * base + min(r, extra)
    return x[start:start + base + (1 if r < extra else 0)]


def _case(keys, axis="data", values=None, config=None, limits=None, **kw):
    return dict(keys=keys, values=values, axis=axis, config=config or {},
                limits=limits or {}, kw=kw)


def cases() -> dict:
    rng = np.random.default_rng(21)
    n = 8192
    paper = dict(tile=256, capacity_factor=1.5)  # tests/test_distributed.py's config
    fast = dict(paper, use_pallas=False)
    uniform = rng.uniform(0, 1, n).astype(np.float32)
    four = rng.integers(0, 4, n).astype(np.int32)
    nan = rng.uniform(-1, 1, n).astype(np.float32)
    nan[rng.random(n) < 0.05] = np.nan
    return {
        # tests/test_distributed.py:27-47, through the kernels' twins
        "uniform": _case(uniform, config=paper),
        "dup3": _case(rng.integers(0, 3, n).astype(np.int32), config=fast),
        # tests/test_distributed.py:49-69: a payload over the axis tuple
        "kv10_pod": _case(rng.integers(0, 10, n).astype(np.int32), ("data", "model"),
                          values=np.arange(n, dtype=np.int32), config=dict(capacity_factor=1.5)),
        # paper Table II: 4 distinct values over both axes
        "table2": _case(four, ("data", "model"), config=dict(tile=256)),
        # an argsort whose tied runs cross blocks (the tie stitch)
        "order_asc": _case(rng.integers(0, 50, n).astype(np.int32), want="order",
                           config=fast),
        "payload_desc": _case(np.round(rng.uniform(-4, 4, n), 1).astype(np.float32),
                              ("data", "model"), values=rng.uniform(size=n).astype(np.float32),
                              order="desc", config=fast),
        "keys_desc": _case(rng.normal(size=n).astype(np.float32), ("data", "model"),
                           order="desc", config=fast),
        "keys_desc_data": _case(rng.integers(-5, 5, n).astype(np.int16), order="desc",
                                config=fast),
        # 8003 = 4 * 2000 + 3: pad_grid's split, sentinel pads, trimmed counts
        "pad8003": _case(rng.uniform(0, 1, 8003).astype(np.float32), config=fast),
        "pad8003_order_desc": _case(rng.integers(0, 40, 8003).astype(np.int32), want="order",
                                    order="desc", config=fast),
        "nan": _case(nan, config=fast),
        # the ladder: 4 values at capacity_factor 0.25 retry in lockstep
        "ladder": _case(four, config=dict(fast, capacity_factor=0.25)),
        # only coordinate 0 overflows on its own: it holds the lowest quarter
        # of the keys, all bound for destination 0, while the others spread
        # theirs over destinations 1-3 within the capacity
        "lockstep": _case(np.concatenate([rng.permutation(2048),
                                          rng.permutation(np.arange(2048, n))]).astype(np.int32),
                          config=dict(fast, capacity_factor=1.5)),
        **multikey_cases(),
    }


def n_of(case: dict) -> int:
    keys = case["keys"]
    return (keys[0] if isinstance(keys, tuple) else keys).shape[0]


def multikey_cases() -> dict:
    """Tuple sorts over the mesh (``repro`` runs them under the host
    decode): packed and LSD, both wants, mixed orders, payloads, declared
    widths, a float column, one empty rank (7 keys over 8 ranks)."""
    rng = np.random.default_rng(27)
    n = 8192
    fast = dict(tile=256, capacity_factor=1.5, use_pallas=False)
    four = rng.integers(0, 4, n).astype(np.int32)
    forty = rng.integers(0, 40, n).astype(np.int32)
    return {
        # paper Table II as tuples: 4 values x 2^16
        "mk_packed": _case((four, rng.integers(0, 1 << 16, n).astype(np.int32)),
                           order=("desc", "asc"), config=fast),
        # packed ties across blocks: the tie stitch on packed keys
        "mk_packed_order": _case((four, forty), ("data", "model"), want="order", config=fast),
        "mk_packed_payload": _case((rng.integers(-3, 3, n).astype(np.int16),
                                    rng.integers(0, 200, n).astype(np.uint8)),
                                   ("data", "model"), values=rng.uniform(size=n).astype(np.float32),
                                   order=("desc", "desc"), config=fast),
        # 2 + 32 bits: LSD passes, with a payload
        "mk_lsd": _case((four, rng.normal(size=n).astype(np.float32)),
                        values=rng.uniform(size=n).astype(np.float32), order=("asc", "desc"),
                        config=fast),
        "mk_lsd_order": _case((rng.integers(0, 3, n).astype(np.int32),
                               rng.integers(-5, 5, n).astype(np.int16),
                               rng.integers(0, 1 << 32, n, dtype=np.uint32)),
                              ("data", "model"), want="order", order=("desc", "asc", "desc"),
                              config=fast),
        "mk_lsd_forced_pad8003": _case((four[:8003], forty[:8003]), order=("asc", "desc"),
                                       limits=dict(multikey="lsd"), config=fast),
        "mk_key_bits": _case((rng.integers(0, 16, n).astype(np.int32),
                              rng.integers(0, 1000, n).astype(np.int32)),
                             want="order", limits=dict(key_bits=(4, None)), config=fast),
        # a float column that packs: [1, 2) in steps of 0.01, 23 + 6 bits
        "mk_float": _case((np.round(rng.uniform(1, 2, n), 2).astype(np.float32),
                           rng.integers(0, 64, n).astype(np.int32)),
                          values=np.arange(n, dtype=np.int32), config=fast),
        # 7 keys over 8 ranks: the last shard is empty
        "mk_empty_rank": _case((np.array([3, 1, 3, 0, 1, 2, 3], np.int32),
                                np.array([5, 9, 2, 7, 7, 1, 0], np.int32)), ("data", "model"),
                               values=np.arange(7, dtype=np.float32), order=("asc", "desc"),
                               config=fast),
    }


def multikey_error_cases() -> dict:
    """Tuple requests that one rank's shard makes ``repro`` refuse: a value
    past its declared width in coordinate 2's shard, and a NaN in
    coordinate 1's shard of a float column that must run LSD."""
    rng = np.random.default_rng(28)
    n = 8192
    bits = rng.integers(0, 16, n).astype(np.int32)
    bits[5000] = 21  # coordinate 2 of 4 holds [4096, 6144)
    nan = rng.normal(size=n).astype(np.float32)
    nan[3000] = np.nan  # coordinate 1
    return {
        "key_bits": _case((bits, rng.integers(0, 9, n).astype(np.int32)),
                          limits=dict(key_bits=(4, None)), config=dict(use_pallas=False)),
        "nan": _case((rng.integers(0, 4, n).astype(np.int32), nan),
                     config=dict(use_pallas=False)),
    }


def x64_pair() -> tuple:
    """An int64 pair that packs into 63 bits only in x64 mode: ids over 2^40
    (41 bits measured) and times over 2^16."""
    rng = np.random.default_rng(29)
    return (rng.integers(0, 1 << 40, 8192) >> 30 << 30,
            rng.integers(0, 1 << 16, 8192).astype(np.int64))


def library_cases() -> dict:
    """``SortLibrary().distributed_sort[_kv]`` (no retry): one overflows."""
    rng = np.random.default_rng(22)
    four = rng.integers(0, 4, 8192).astype(np.int32)
    return {
        "lib_overflow": dict(keys=four, values=None, axis="data",
                             config=dict(capacity_factor=0.25, use_pallas=False)),
        "lib_kv": dict(keys=rng.uniform(size=8192).astype(np.float32),
                       values=np.arange(8192, dtype=np.int32), axis=("data", "model"),
                       config=dict(tile=256, use_pallas=False)),
    }


def traced_case() -> dict:
    rng = np.random.default_rng(23)
    return _case(rng.uniform(0, 1, 8192).astype(np.float32), config=dict(tile=256,
                 use_pallas=False))


def topk_inputs() -> dict:
    """Per-case global arrays for ``topk_shard`` over "data": ties, +-0.0,
    NaN and the int32 minimum, whose negation wraps under largest=False."""
    rng = np.random.default_rng(24)
    f = rng.integers(-3, 4, 64).astype(np.float32)
    f[rng.random(64) < 0.2] = -0.0
    f[[5, 40]] = np.nan
    f[[9]] = -np.nan
    i = rng.integers(-3, 4, 64).astype(np.int32)
    i[[3, 30, 50]] = np.iinfo(np.int32).min
    i[[7]] = np.iinfo(np.int32).max
    return {"float32": f, "int32": i}


# ------------------------------------------------------------------- MoE

MOE_MESH_SHAPE = (2, 4)
# the smoke deepseek-moe-16b widths (repro's smoke_config): d_model,
# n_experts, d_expert
MOE_D, MOE_E, MOE_DE = 64, 8, 32


def moe_inputs() -> tuple[dict, np.ndarray]:
    """(router, wi, wg, wo as float32, drawn as ``init_moe`` scales them;
    the global (4, 16, d) tokens)."""
    rng = np.random.default_rng(31)

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    weights = {"router": draw((MOE_D, MOE_E), MOE_D ** -0.5),
               "wi": draw((MOE_E, MOE_D, MOE_DE), MOE_D ** -0.5),
               "wg": draw((MOE_E, MOE_D, MOE_DE), MOE_D ** -0.5),
               "wo": draw((MOE_E, MOE_DE, MOE_D), MOE_DE ** -0.5)}
    return weights, rng.standard_normal((4, 16, MOE_D)).astype(np.float32)


# EP x TP decode (tests/test_torch_sharded_serve.py): name -> capacity
# factor; the (4, 1) tokens on a (2, 2) mesh drop assignments below 8
MOE_TP_CASES = {"capacity_8": 8.0, "capacity_1.25": 1.25, "capacity_0.5": 0.5}


def moe_cases() -> dict:
    """name -> expert_2d, the ``ModelConfig`` fields over the smoke config
    at capacity factor 8 in float32, and the sequence length used (S = 1:
    the tokens are replicated over "model")."""
    return {
        "ep1d": dict(expert_2d=False, cfg={}, S=16),
        "ep2d": dict(expert_2d=True, cfg={}, S=16),
        "ep2d_hierarchical": dict(expert_2d=True, cfg={"hierarchical_a2a": True}, S=16),
        "ep1d_capacity_1.25": dict(expert_2d=False, cfg={"moe_capacity_factor": 1.25}, S=16),
        "ep2d_s1": dict(expert_2d=True, cfg={}, S=1),
    }
