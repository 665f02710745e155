"""One rank of the gloo side of tests/test_torch_dryrun.py.

    python tests/torch_dryrun_worker.py RANK WORLD STORE_FILE DIR

Joins a gloo group of WORLD (4) CPU processes through a file store and
wraps every collective of ``spec.AxisGroup`` so that the outermost call
adds the bytes it returns (``spec.out_bytes``) to the mesh's ``colls``
under ``repro``'s kind name (``spec.COLL_KINDS``): the port's
``reduce_scatter`` is an all-to-all and a sum, and counts once. Then, for
each case of ``CASES``, it runs ``dryrun.run_counted`` on a (2, 2)
``DeviceMesh``: the rank's real program on the CPU, its collectives
moving bytes. The counts go to ``DIR/rank<RANK>.json``. It imports
nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import pathlib
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.registry import smoke_config
from repro_torch.launch import dryrun
from repro_torch.sharding import spec

MESH = ((2, 2), ("data", "model"))
# name -> (arch, (seq, global batch, kind))
CASES = {f"{name}/{kind}": (arch, (32, 4, kind))
         for name, arch in (("qwen3", "qwen3-4b"), ("moe", "deepseek-moe-16b"))
         for kind in ("train", "prefill")}


def config(arch: str):
    """The smoke config in float32 (gloo reduces no bfloat16)."""
    return dataclasses.replace(smoke_config(arch), dtype="float32")


def record_collectives(mesh) -> None:
    """Every ``AxisGroup`` collective adds its output's bytes to
    ``mesh.colls``, the outermost call only."""
    mesh.colls = {}
    depth = [0]

    def wrap(name):
        real = getattr(spec.AxisGroup, name)

        @functools.wraps(real)
        def wrapped(self, *args, **kwargs):
            depth[0] += 1
            try:
                out = real(self, *args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                kind = spec.COLL_KINDS[name]
                mesh.colls[kind] = mesh.colls.get(kind, 0) + spec.out_bytes(out)
            return out

        setattr(spec.AxisGroup, name, wrapped)

    for name in spec.COLL_KINDS:
        wrap(name)


def main(rank: int, world: int, store: str, d: pathlib.Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    shape, names = MESH
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape), mesh_dim_names=names)
    record_collectives(mesh)
    out = {}
    for case, (arch, cell) in CASES.items():
        got = dryrun.run_counted(config(arch), cell, mesh=mesh, device="cpu", seed=3)
        out[case] = {k: got[k] for k in ("colls", "dot_flops", "kernels")}
    dist.destroy_process_group()
    (d / f"rank{rank}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], pathlib.Path(sys.argv[4]))
