"""One rank of the port's side of tests/test_torch_mesh.py.

    python tests/torch_mesh_worker.py RANK WORLD STORE_FILE OUT_DIR [moe|compress]

Joins a gloo group of WORLD (8) processes through a file store, builds a
``DeviceMesh("cpu", (4, 2), ("data", "model"))`` and runs every case of
tests/torch_mesh_cases.py on its own shard with ``device="cpu"``, both
decodes, writing ``OUT_DIR/rank<RANK>.npz``: each output's block, counts,
send counts, retries, overflow flag and raw row (a tuple's key columns as
``<name>/keys/<j>``); the ValueError each rank raises on the tuple requests
that one shard makes the sort refuse; the raw rows of
``distributed_sort[_kv]`` and ``distributed_sort_phased``; the ``SortLibrary``
cases and the unequal-shard ValueError; the traced sort's spans; the
first attempt's local and reduced overflow flags of the lockstep case;
``topk_shard``; ``vocab_pad``; and int64 sorts and an int64 pair packed
into 63 bits in x64 mode. It imports
nothing of JAX.

With ``compress`` it runs ``optim.compress.compressed_psum_mean`` over a
``DeviceMesh("cpu", (WORLD,), ("data",))`` on a seeded x per rank, writing
``x`` and ``mean`` (tests/test_torch_optim.py).

With ``moe`` it runs the MoE cases instead (tests/test_torch_moe_mesh.py)
on a ``DeviceMesh("cpu", (2, 4))``: each case's ``moe_forward`` on this
rank's block of the tokens (``moe.local_tokens``) and experts
(``moe.shard_params``), with both sort paths, writing ``<name>/out/<0|1>``
(``use_pallas``), ``<name>/aux/<0|1>`` and ``<name>/pos``, the global
indices b * S + s of the block's tokens.
"""
from __future__ import annotations

import datetime
import pathlib
import sys
import warnings

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_mesh_cases as C  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import sample_sort, topk  # noqa: E402
from repro_torch.sharding import spec  # noqa: E402

PHASES = ("local_sort", "splitter", "exchange", "merge")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_output(out: dict, name: str, o) -> None:
    if isinstance(o.keys, tuple):
        for j, col in enumerate(o.keys):
            out[f"{name}/keys/{j}"] = _np(col)
    else:
        out[f"{name}/keys"] = _np(o.keys)
    if o.values is not None:
        out[f"{name}/values"] = _np(o.values)
    out[f"{name}/counts"] = np.asarray(o.counts)
    if o.send_counts is not None:  # None after LSD passes, as in repro
        out[f"{name}/send_counts"] = np.asarray(o.send_counts)
    out[f"{name}/retries"] = np.asarray(o.meta.retries)
    out[f"{name}/overflowed"] = np.asarray(o.overflowed)
    out[f"{name}/block"] = np.asarray(o.block)
    out[f"{name}/n"] = np.asarray(o.meta.n)
    if o.raw is not None:
        save_raw(out, name, o.raw)


def save_raw(out: dict, name: str, raw) -> None:
    if isinstance(raw, sample_sort.ShardSortKVResult):
        out[f"{name}/raw_keys"] = _np(raw.keys)
    out[f"{name}/raw_values"] = _np(raw.values)
    out[f"{name}/raw_count"] = _np(raw.count)
    out[f"{name}/raw_send_counts"] = _np(raw.send_counts)
    out[f"{name}/raw_overflowed"] = np.asarray(raw.overflowed)


def local_input(case: dict, rank: int):
    p, r = C.axis_size(case["axis"]), C.axis_coord(rank, case["axis"])
    values = None if case["values"] is None else C.shard(case["values"], p, r)
    keys = case["keys"]
    if isinstance(keys, tuple):
        return tuple(C.shard(k, p, r) for k in keys), values
    return C.shard(keys, p, r), values


def join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", DeprecationWarning)
    torch.distributed.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                         world_size=world,
                                         timeout=datetime.timedelta(seconds=120))


def moe_main(rank: int, world: int, store: str, out_dir: str) -> None:
    import dataclasses

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import moe

    join(rank, world, store)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(C.MOE_MESH_SHAPE),
                      mesh_dim_names=C.MESH_AXES)
    weights, x = C.moe_inputs()
    full = moe.MoE(*(torch.from_numpy(weights[n]) for n in ("router", "wi", "wg", "wo")))
    out: dict = {}
    for name, case in C.moe_cases().items():
        cfg = dataclasses.replace(smoke_config("deepseek-moe-16b"), **{
            "moe_capacity_factor": 8.0, "dtype": "float32", **case["cfg"]})
        axes = spec.from_mesh(mesh, expert_2d=case["expert_2d"])
        xg = torch.from_numpy(x[:, :case["S"]])
        B, S, _ = xg.shape
        out[f"{name}/pos"] = _np(moe.local_tokens(torch.arange(B * S).reshape(B, S, 1), axes))
        local = moe.shard_params(full, axes)
        for use_pallas in (0, 1):
            o, aux = moe.moe_forward(moe.local_tokens(xg, axes), local, cfg, axes,
                                     use_pallas=bool(use_pallas))
            out[f"{name}/out/{use_pallas}"] = _np(o)
            out[f"{name}/aux/{use_pallas}"] = _np(aux)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    join(rank, world, store)
    dist = torch.distributed
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(world).reshape(C.MESH_SHAPE),
                      mesh_dim_names=C.MESH_AXES)
    out: dict = {}
    for name, case in C.cases().items():
        keys, values = local_input(case, rank)
        for decode in ("device", "host"):
            o = repro_torch.sort(keys, values, where=(mesh, case["axis"]), device="cpu",
                                 config=repro_torch.SortConfig(**case["config"]),
                                 limits=repro_torch.SortLimits(decode=decode, **case["limits"]),
                                 **case["kw"])
            save_output(out, f"{name}/{decode}", o)

    # tuples that one rank's shard makes the sort refuse: every rank raises
    for name, case in C.multikey_error_cases().items():
        keys, _ = local_input(case, rank)
        try:
            repro_torch.sort(keys, where=(mesh, case["axis"]), device="cpu",
                             config=repro_torch.SortConfig(**case["config"]),
                             limits=repro_torch.SortLimits(**case["limits"]))
        except ValueError as e:
            out[f"error/{name}"] = np.asarray(str(e))

    # the entry points under the planner, on divisible shards
    for name, entry in (("uniform", sample_sort.distributed_sort),
                        ("kv10_pod", sample_sort.distributed_sort_kv),
                        ("dup3", sample_sort.distributed_sort_phased)):
        case = C.cases()[name]
        keys, values = local_input(case, rank)
        args = [torch.from_numpy(keys)] + ([] if values is None else [torch.from_numpy(values)])
        kw = {"trace": obs.tracing.Trace()} if name == "dup3" else {}
        save_raw(out, f"direct/{name}", entry(*args, mesh, case["axis"],
                                              repro_torch.SortConfig(**case["config"]), **kw))

    # the lockstep case's first attempt: the local and the reduced flag
    case = C.cases()["lockstep"]
    keys, _ = local_input(case, rank)
    cfg = repro_torch.SortConfig(**case["config"])
    first = sample_sort.sample_sort_shard(torch.from_numpy(keys), (mesh, "data"), cfg)
    cap = cfg.capacity(C.axis_size("data"), keys.shape[0])
    out["lockstep/local_overflow"] = np.asarray(bool((first.send_counts > cap).any()))
    out["lockstep/reduced_overflow"] = np.asarray(first.overflowed)

    for name, case in C.library_cases().items():
        lib = repro_torch.SortLibrary(config=repro_torch.SortConfig(**case["config"]),
                                      device="cpu")
        keys, values = local_input(case, rank)
        if values is None:
            raw = lib.distributed_sort(keys, mesh, case["axis"])
        else:
            raw = lib.distributed_sort_kv(keys, values, mesh, case["axis"])
        save_raw(out, name, raw)
    try:
        keys, _ = local_input(C.cases()["pad8003"], rank)
        repro_torch.SortLibrary(device="cpu").distributed_sort(keys, mesh, "data")
    except ValueError as e:
        out["lib_unequal/error"] = np.asarray(str(e))

    case = C.traced_case()
    keys, _ = local_input(case, rank)
    for decode in ("device", "host"):
        o = repro_torch.sort(keys, where=(mesh, case["axis"]), device="cpu",
                             config=repro_torch.SortConfig(**case["config"]),
                             limits=repro_torch.SortLimits(decode=decode, trace=True))
        out[f"traced/{decode}/names"] = np.array([s.name for s in o.meta.trace.spans])
        for s in o.meta.trace.spans:
            if s.name in PHASES:
                if "per_proc" in s.attrs:
                    out[f"traced/{decode}/{s.name}/per_proc"] = np.asarray(s.attrs["per_proc"])
                if "overflowed" in s.attrs:
                    out[f"traced/{decode}/{s.name}/overflowed"] = np.asarray(
                        s.attrs["overflowed"])
        out[f"traced/{decode}/keys"] = _np(o.keys)
        out[f"traced/{decode}/block"] = np.asarray(o.block)

    r = C.axis_coord(rank, "data")
    for dtype, x in C.topk_inputs().items():
        for largest in (True, False):
            v, i = topk.topk_shard(torch.from_numpy(C.shard(x, 4, r)), C.TOPK_K,
                                   (mesh, "data"), largest)
            out[f"topk/{dtype}/{largest}/values"] = _np(v)
            out[f"topk/{dtype}/{largest}/indices"] = _np(i)

    axes = spec.from_mesh(mesh)
    for vocab in (1000, 151_936, 7):
        for multiple in (128, 1):
            out[f"vocab_pad/{vocab}/{multiple}"] = np.asarray(spec.vocab_pad(vocab, axes,
                                                                             multiple))

    # x64 mode: int64 keys (8 values) keys-only and argsorted, over "data"
    x64 = np.random.default_rng(25).integers(-(1 << 40), 1 << 40, 8192) >> 38
    pair = C.x64_pair()
    with repro_torch.x64_mode():
        for want in ("values", "order"):
            o = repro_torch.sort(C.shard(x64, 4, r), where=(mesh, "data"), want=want,
                                 device="cpu", config=repro_torch.SortConfig(tile=256))
            save_output(out, f"x64/{want}", o)
            o = repro_torch.sort(tuple(C.shard(k, 4, r) for k in pair), where=(mesh, "data"),
                                 want=want, order=("desc", "asc"), device="cpu",
                                 config=repro_torch.SortConfig(tile=256))
            save_output(out, f"x64_pair/{want}", o)
            out[f"x64_pair/{want}/multikey"] = np.asarray(o.meta.multikey)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def compress_main(rank: int, world: int, store: str, out_dir: str) -> None:
    """``optim.compress.compressed_psum_mean`` over all ranks on "data":
    writes this rank's seeded x and the mean it received."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.optim import compress

    join(rank, world, store)
    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
    x = np.random.default_rng((31, rank)).standard_normal(
        compress.CHUNK * world * 4).astype(np.float32)
    mean = compress.compressed_psum_mean(torch.from_numpy(x), (mesh, "data"))
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", x=x, mean=_np(mean))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    entry = {"moe": moe_main, "compress": compress_main}.get(sys.argv[5] if sys.argv[5:] else "",
                                                              main)
    entry(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
