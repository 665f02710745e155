"""One rank of a mesh sort on the card, for tests/test_torch_cuda.py.

    python tests/torch_mesh_card.py RANK WORLD BACKEND STORE_FILE OUT_DIR

Joins a group of WORLD processes (BACKEND "nccl" for one rank, "gloo"
for several ranks sharing cuda:0) through a file store, sorts its
``pad_grid`` shard of 2^16 + 5 seeded float32 keys with
``repro_torch.sort(x_local, where=(mesh, "data"))`` on the card, keys
only, want="order" and keys-only descending, then its shards of the
``MK_CALLS`` tuples (a packed pair, keys-only and argsorted, and an LSD
pair with a payload), and writes its blocks, counts and send counts to
``OUT_DIR/rank<RANK>.npz``.
"""
from __future__ import annotations

import datetime
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_mesh_cases as C  # noqa: E402

import repro_torch  # noqa: E402

N = (1 << 16) + 5
CALLS = {"keys": {}, "order": {"want": "order"}, "desc": {"order": "desc"}}
# tuples: a packed pair (keys-only and argsort) and an LSD pair with a payload
MK_CALLS = {"mk_packed": {"order": ("desc", "asc")},
            "mk_packed_order": {"want": "order"},
            "mk_lsd": {"order": ("asc", "desc"), "values": True}}


def keys() -> np.ndarray:
    return np.random.default_rng(27).integers(0, 1000, N).astype(np.float32)


def tuple_inputs(name: str) -> tuple:
    """(key columns, payload) of a ``MK_CALLS`` case: 4 int32 values with
    int32 in [0, 2^16) (packs into 18 bits), or with float32 normals (34
    bits: LSD) and a float32 payload."""
    rng = np.random.default_rng(28)
    four = rng.integers(0, 4, N).astype(np.int32)
    second = (rng.normal(size=N).astype(np.float32) if name == "mk_lsd"
              else rng.integers(0, 1 << 16, N).astype(np.int32))
    values = rng.uniform(size=N).astype(np.float32) if MK_CALLS[name].get("values") else None
    return (four, second), values


def main(rank: int, world: int, backend: str, store: str, out_dir: str) -> None:
    torch.cuda.set_device(0)
    dist = torch.distributed
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
    x = torch.from_numpy(C.shard(keys(), world, rank)).cuda()
    out = {}
    for name, kw in CALLS.items():
        o = repro_torch.sort(x, where=(mesh, "data"), **kw)
        assert o.keys.device.type == "cuda"
        out[f"{name}/keys"] = o.keys.cpu().numpy()
        if o.values is not None:
            out[f"{name}/values"] = o.values.cpu().numpy()
        out[f"{name}/counts"] = o.counts
        out[f"{name}/send_counts"] = o.send_counts
        out[f"{name}/reasons"] = np.asarray("\n".join(o.meta.plan.reasons))
    for name, kw in MK_CALLS.items():
        cols, values = tuple_inputs(name)
        kw = {k: v for k, v in kw.items() if k != "values"}
        vals = None if values is None else torch.from_numpy(C.shard(values, world, rank)).cuda()
        o = repro_torch.sort(tuple(torch.from_numpy(C.shard(c, world, rank)).cuda()
                                   for c in cols), vals, where=(mesh, "data"), **kw)
        assert all(c.device.type == "cuda" for c in o.keys)
        for j, c in enumerate(o.keys):
            out[f"{name}/keys/{j}"] = c.cpu().numpy()
        if o.values is not None:
            out[f"{name}/values"] = o.values.cpu().numpy()
        out[f"{name}/counts"] = o.counts
        out[f"{name}/multikey"] = np.asarray(o.meta.multikey)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
