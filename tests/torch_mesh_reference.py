"""Run the cases of tests/torch_mesh_cases.py through ``repro``'s mesh path
and save what comes out, for tests/test_torch_mesh.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/torch_mesh_reference.py OUT.npz [moe]

The mesh is ``jax.make_mesh((4, 2), ("data", "model"))`` on 8 virtual
host devices, so this runs in a process of its own. Every sorted output
is read through ``np.asarray`` and ``repro``'s host decode: its device
decode raises ShardingTypeError on a sharded grid (jax 0.9), and so does
``SortLibrary.distributed_sort[_kv]``, which reads through it. Per case the
npz holds ``<name>/keys`` (a tuple's columns as ``<name>/keys/<j>``), ``/values``, ``/counts``, ``/send_counts``,
``/retries``, ``/overflowed`` and the raw grid (``/raw_values``,
``/raw_keys`` for kv, ``/raw_count``, ``/raw_send_counts``); the
``SortLibrary`` cases their raw grids; the tuple requests it refuses
their ValueError texts (``error/<name>``); the traced sort its span names and
per-device counts; ``topk_shard``'s answers; ``vocab_pad``'s.

With ``moe`` it runs the MoE cases instead (tests/test_torch_moe_mesh.py):
``repro``'s ``moe_forward`` on ``jax.make_mesh((2, 4), ("data",
"model"))``, as tests/test_distributed.py runs it, writing each case's
global output and aux loss as ``<name>/out`` and ``<name>/aux``. With
``moe_tp`` (tests/test_torch_sharded_serve.py, 4 virtual devices) it runs
``repro``'s EP x TP decode dispatch, ``moe_forward(..., tp_axis="model")``
with experts over "data", on ``jax.make_mesh((2, 2), ("data", "model"))``
at S = 1, for each capacity factor of ``torch_mesh_cases.MOE_TP_CASES``.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_mesh_cases as C  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro  # noqa: E402
from repro.core import topk as rtopk  # noqa: E402
from repro.sharding import spec as rspec  # noqa: E402

PHASES = ("local_sort", "splitter", "exchange", "merge")


def _raw(out: dict, name: str, raw) -> None:
    if hasattr(raw, "keys") and not callable(raw.keys):
        out[f"{name}/raw_keys"] = np.asarray(raw.keys)
    out[f"{name}/raw_values"] = np.asarray(raw.values)
    out[f"{name}/raw_count"] = np.asarray(raw.count)
    out[f"{name}/raw_send_counts"] = np.asarray(raw.send_counts)
    out[f"{name}/raw_overflowed"] = np.asarray(raw.overflowed)


def moe_main(path: str) -> None:
    import dataclasses

    from repro.configs.registry import smoke_config
    from repro.models import moe

    mesh = jax.make_mesh(C.MOE_MESH_SHAPE, C.MESH_AXES)
    weights, x = C.moe_inputs()
    p = {k: jnp.asarray(v) for k, v in weights.items()}
    out: dict = {}
    for name, case in C.moe_cases().items():
        cfg = dataclasses.replace(smoke_config("deepseek-moe-16b"), **{
            "moe_capacity_factor": 8.0, "dtype": "float32", **case["cfg"]})
        assert (cfg.d_model, cfg.n_experts, cfg.d_expert) == (C.MOE_D, C.MOE_E, C.MOE_DE)
        axes = rspec.from_mesh(mesh, expert_2d=case["expert_2d"])
        with rspec.set_mesh_compat(mesh):
            o, aux = jax.jit(lambda x, p, cfg=cfg, axes=axes: moe.moe_forward(x, p, cfg, axes))(
                jnp.asarray(x[:, :case["S"]]), p)
        out[f"{name}/out"] = np.asarray(o)
        out[f"{name}/aux"] = np.asarray(aux)
    np.savez(path, **out)


def moe_tp_main(path: str) -> None:
    import dataclasses

    from repro.configs.registry import smoke_config
    from repro.models import moe

    mesh = jax.make_mesh((2, 2), C.MESH_AXES, devices=jax.devices()[:4])
    weights, x = C.moe_inputs()
    p = {k: jnp.asarray(v) for k, v in weights.items()}
    axes = dataclasses.replace(rspec.from_mesh(mesh, expert_2d=True), expert=("data",))
    out: dict = {}
    for name, cf in C.MOE_TP_CASES.items():
        cfg = dataclasses.replace(smoke_config("deepseek-moe-16b"), dtype="float32",
                                  moe_capacity_factor=cf)
        with rspec.set_mesh_compat(mesh):
            o, aux = jax.jit(lambda x, p, cfg=cfg: moe.moe_forward(
                x, p, cfg, axes, tp_axis="model"))(jnp.asarray(x[:, :1]), p)
        out[f"{name}/out"] = np.asarray(o)
        out[f"{name}/aux"] = np.asarray(aux)
    np.savez(path, **out)


def main(path: str) -> None:
    mesh = jax.make_mesh(C.MESH_SHAPE, C.MESH_AXES)
    out: dict = {}
    for name, case in C.cases().items():
        r = repro.sort(case["keys"], case["values"], where=(mesh, case["axis"]),
                       config=repro.SortConfig(**case["config"]),
                       limits=repro.SortLimits(decode="host", **case["limits"]), **case["kw"])
        if isinstance(r.keys, tuple):
            for j, col in enumerate(r.keys):
                out[f"{name}/keys/{j}"] = np.asarray(col)
        else:
            out[f"{name}/keys"] = np.asarray(r.keys)
        if r.values is not None:
            out[f"{name}/values"] = np.asarray(r.values)
        out[f"{name}/counts"] = np.asarray(r.counts)
        if r.send_counts is not None:  # None after LSD passes
            out[f"{name}/send_counts"] = np.asarray(r.send_counts)
        out[f"{name}/retries"] = np.asarray(r.meta.retries)
        out[f"{name}/overflowed"] = np.asarray(r.overflowed)
        if r.raw is not None:
            _raw(out, name, r.raw)
    for name, case in C.multikey_error_cases().items():
        try:
            repro.sort(case["keys"], where=(mesh, case["axis"]),
                       config=repro.SortConfig(**case["config"]),
                       limits=repro.SortLimits(decode="host", **case["limits"]))
        except ValueError as e:
            out[f"error/{name}"] = np.asarray(str(e))

    # SortLibrary.distributed_sort[_kv] is this sort with no retry, read
    # through the device decode, which raises on jax 0.9: its raw grid
    # comes from the same call with the host decode
    no_retry = repro.SortLimits(max_doublings=0, raise_on_overflow=False, decode="host")
    for name, case in C.library_cases().items():
        r = repro.sort(case["keys"], case["values"], where=(mesh, case["axis"]),
                       config=repro.SortConfig(**case["config"]), limits=no_retry)
        _raw(out, name, r.raw)

    case = C.traced_case()
    r = repro.sort(case["keys"], where=(mesh, case["axis"]),
                   config=repro.SortConfig(**case["config"]),
                   limits=repro.SortLimits(decode="host", trace=True))
    r.keys
    spans = r.meta.trace.spans
    out["traced/names"] = np.array([s.name for s in spans])
    for s in spans:
        if s.name in PHASES:
            if "per_proc" in s.attrs:
                out[f"traced/{s.name}/per_proc"] = np.asarray(s.attrs["per_proc"])
            if "overflowed" in s.attrs:
                out[f"traced/{s.name}/overflowed"] = np.asarray(s.attrs["overflowed"])
    out["traced/keys"] = np.asarray(r.keys)

    for dtype, x in C.topk_inputs().items():
        for largest in (True, False):
            f = rspec.shard_map_compat(
                lambda xl, largest=largest: rtopk.topk_shard(xl, C.TOPK_K, "data", largest),
                mesh=mesh, in_specs=P("data"), out_specs=(P(), P()))
            v, i = f(jnp.asarray(x))
            out[f"topk/{dtype}/{largest}/values"] = np.asarray(v)
            out[f"topk/{dtype}/{largest}/indices"] = np.asarray(i)

    axes = rspec.from_mesh(mesh)
    for vocab in (1000, 151_936, 7):
        for multiple in (128, 1):
            out[f"vocab_pad/{vocab}/{multiple}"] = np.asarray(
                rspec.vocab_pad(vocab, axes, multiple))
    np.savez(path, **out)


if __name__ == "__main__":
    mode = sys.argv[2:3]
    {("moe",): moe_main, ("moe_tp",): moe_tp_main}.get(tuple(mode), main)(sys.argv[1])
