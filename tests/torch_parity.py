"""Helpers for the parity tests of ``repro_torch`` against ``repro``.

Inputs are numpy arrays made from a seed; each goes through the JAX
function and its port (on the CPU) and the outputs are compared bit for
bit, since sorting is exact. bfloat16 arrives from the port as its uint16
bit patterns (``repro_torch.convert.to_numpy``), so every comparison is
made on bit views.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

import repro
import repro_torch
from repro_torch import convert

DTYPES = ["float32", "int32", "uint32", "int8", "uint8", "int16", "uint16",
          "float16", "bfloat16"]


def np_dtype(name: str):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def bits(a) -> np.ndarray:
    """The bit patterns of an array (bfloat16 and float16 as uint16)."""
    a = np.asarray(a)
    if a.dtype.kind in "fiV" or a.dtype.name == "bfloat16":
        return a.view(f"u{a.dtype.itemsize}")
    return a


def assert_bits_equal(a, b) -> None:
    a, b = bits(a), bits(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def tt(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor."""
    return convert.to_tensor(a, "cpu")


def port_np(t) -> np.ndarray:
    return convert.to_numpy(t)


def make_keys(rng: np.random.Generator, n, dtype: str, *, distinct: int | None = None,
              zeros: bool = True) -> np.ndarray:
    """Keys of ``dtype`` away from the dtype's extremes (so payload sorts
    are admitted in both orders); ``distinct`` draws from that many values;
    float keys carry +0.0 and -0.0 ties."""
    if distinct is not None:
        x = rng.integers(0, distinct, n)
        return x.astype(np.float32).astype(np_dtype(dtype)) if "float" in dtype else x.astype(dtype)
    if "float" in dtype:
        x = rng.standard_normal(n).astype(np.float32)
        if zeros:
            x.reshape(-1)[::7] = 0.0
            x.reshape(-1)[::11] = -0.0
        return x.astype(np_dtype(dtype))
    info = np.iinfo(dtype)
    return rng.integers(int(info.min) + 1, int(info.max), n).astype(dtype)


def port_config(cfg):
    return None if cfg is None else convert.config_from_dict(dataclasses.asdict(cfg))


def port_limits(lim):
    return None if lim is None else convert.limits_from_dict(dataclasses.asdict(lim))


def sort_both(keys, values=None, *, config=None, limits=None, **kw):
    """The same request through ``repro.sort`` on sim and the port on CPU."""
    r = repro.sort(keys, values, where="sim", config=config, limits=limits, **kw)
    t = repro_torch.sort(keys, values, config=port_config(config),
                         limits=port_limits(limits), device="cpu", **kw)
    return r, t


def assert_sort_equal(r, t) -> None:
    """Every field the two SortOutputs share is the same, bit for bit."""
    o = convert.output_to_numpy(t)
    assert_bits_equal(r.keys, o["keys"])
    if r.values is None:
        assert o["values"] is None
    else:
        assert_bits_equal(r.values, o["values"])
    assert r.counts.dtype == o["counts"].dtype
    np.testing.assert_array_equal(r.counts, o["counts"])
    np.testing.assert_array_equal(r.send_counts, o["send_counts"])
    assert o["send_counts"].dtype == np.asarray(r.send_counts).dtype
    assert r.overflowed == o["overflowed"]
    assert r.meta.retries == o["retries"]
    assert dataclasses.asdict(r.meta.config) == dataclasses.asdict(o["config"])
    assert r.imbalance() == t.imbalance()


def jx(a: np.ndarray):
    return jnp.asarray(a)


def sort_both_raising(keys, values=None, *, config=None, limits=None, **kw):
    """``sort_both`` where either sort may raise: each output, or the
    exception it raised."""
    def call(fn):
        try:
            return fn()
        except (ValueError, TypeError) as e:
            return e

    r = call(lambda: repro.sort(keys, values, where="sim", config=config, limits=limits, **kw))
    t = call(lambda: repro_torch.sort(keys, values, config=port_config(config),
                                      limits=port_limits(limits), device="cpu", **kw))
    return r, t


def assert_multikey_equal(r, t) -> None:
    """Two multi-key SortOutputs (or the same error from both) agree on
    everything they share: each key column (dtype and bits), values or
    order, counts, send_counts, overflowed, retries, config and the
    multi-key meta."""
    if isinstance(r, Exception) or isinstance(t, Exception):
        assert type(t) is type(r) and str(t) == str(r), (r, t)
        return
    assert isinstance(t.keys, tuple) and len(t.keys) == len(r.keys)
    for a, b in zip(r.keys, t.keys):
        b = port_np(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        assert_bits_equal(a, b)
    if r.values is None:
        assert t.values is None
    else:
        assert_bits_equal(r.values, port_np(t.values))
    np.testing.assert_array_equal(r.counts, t.counts)
    assert np.asarray(r.counts).dtype == np.asarray(t.counts).dtype
    if r.send_counts is None:
        assert t.send_counts is None
    else:
        np.testing.assert_array_equal(r.send_counts, t.send_counts)
    assert r.overflowed == t.overflowed and r.meta.retries == t.meta.retries
    assert dataclasses.asdict(r.meta.config) == dataclasses.asdict(t.meta.config)
    for name in ("multikey", "n_keys", "order", "want", "n"):
        assert getattr(r.meta, name) == getattr(t.meta, name), name
    assert r.imbalance() == t.imbalance() or (np.isnan(r.imbalance()) and np.isnan(t.imbalance()))


BF16_TIE = 2.0 ** -9
"""bfloat16's relative precision: a token whose K-th and (K+1)-th expert
probabilities lie closer than this may be routed to the other expert after
a one-ulp difference in its bfloat16 hidden state."""


def router_margins(monkeypatch) -> list:
    """Record every call of the port's MoE router: per token, the margin
    between its K-th and (K+1)-th expert probability, a float32 tensor per
    call, appended to the returned list. A bfloat16 comparison of whole
    models leaves out the tokens whose margin is below ``BF16_TIE``."""
    from repro_torch.models import moe

    margins, router = [], moe._router

    def record(xf, w, cfg):
        p = torch.softmax(xf.float() @ w, dim=-1).sort(dim=-1, descending=True).values
        margins.append(p[:, cfg.moe_topk - 1] - p[:, cfg.moe_topk])
        return router(xf, w, cfg)

    monkeypatch.setattr(moe, "_router", record)
    return margins


_WORLD_MESH = None


def world_mesh():
    """A one-rank CPU ``DeviceMesh`` with the axis "data" over this process
    (a gloo group through a file store), made once per process and kept:
    the mesh backend's in-process tests share it."""
    global _WORLD_MESH
    if _WORLD_MESH is None:
        import atexit
        import datetime
        import tempfile

        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        if not dist.is_initialized():
            store = pathlib.Path(tempfile.mkdtemp()) / "store"
            dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                                    world_size=1, timeout=datetime.timedelta(seconds=60))
            atexit.register(dist.destroy_process_group)
        _WORLD_MESH = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))
    return _WORLD_MESH


HERE = pathlib.Path(__file__).resolve().parent
MESH_TIMEOUT_S = 240  # for all processes together; a rank's collectives time out at 120 s


def run_mesh_sides(d: pathlib.Path, world: int, *mode: str) -> tuple[dict, list]:
    """Run ``repro``'s side (tests/torch_mesh_reference.py, 8 virtual host
    devices) and ``world`` gloo ranks of the port (tests/torch_mesh_worker.py)
    at the same time, rendezvousing through files in ``d`` (no port is
    taken); ``mode`` goes to both (``"moe"``: the MoE cases). Processes
    still running after MESH_TIMEOUT_S are killed; a failed one's log
    (``d / "rank<r>.log"``, ``d / "ref.log"``) is shown. Returns (repro's
    npz, the port's npz per global rank) as dicts."""
    src = str(HERE.parent / "src")
    path = os.pathsep.join([src, os.environ.get("PYTHONPATH", "")])
    ref_env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    port_env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    runs = [([HERE / "torch_mesh_reference.py", d / "ref.npz", *mode], ref_env, d / "ref.log")]
    runs += [([HERE / "torch_mesh_worker.py", r, world, d / "store", d, *mode], port_env,
              d / f"rank{r}.log") for r in range(world)]
    logs = [open(log, "w") for _, _, log in runs]
    procs = [subprocess.Popen([sys.executable, *map(str, cmd)], env=env, stdout=f,
                              stderr=subprocess.STDOUT) for (cmd, env, _), f in zip(runs, logs)]
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [log for p, (_, _, log) in zip(procs, runs) if p.returncode != 0]
    assert not failed, "\n".join(f"{log.name}: {log.read_text()[-3000:]}" for log in failed)

    def load(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    return load(d / "ref.npz"), [load(d / f"rank{r}.npz") for r in range(world)]
