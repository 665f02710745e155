"""One rank of a mesh sort on the card, for tests/test_torch_cuda.py.

    python tests/torch_mesh_card.py RANK WORLD BACKEND STORE_FILE OUT_DIR

Joins a group of WORLD processes (BACKEND "nccl" for one rank, "gloo"
for several ranks sharing cuda:0) through a file store, sorts its
``pad_grid`` shard of 2^16 + 5 seeded float32 keys with
``repro_torch.sort(x_local, where=(mesh, "data"))`` on the card, keys
only, want="order" and keys-only descending, and writes its blocks,
counts and send counts to ``OUT_DIR/rank<RANK>.npz``.
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


def keys() -> np.ndarray:
    return np.random.default_rng(27).integers(0, 1000, N).astype(np.float32)


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
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
