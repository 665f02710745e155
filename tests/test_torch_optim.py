"""The port's optimizers, schedule, clipping and gradient compression
against ``repro`` on the CPU (``repro/optim/``), on the same seeded numpy
inputs. float32 states and parameters are held within 1e-6 of the
largest magnitude of each tensor; bfloat16 ones within one bfloat16 ulp
of it (2^-8), since a one-ulp float32 difference before the cast can
round to the neighbouring bfloat16; int8 codes and scales bit for bit."""
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jopt
from repro.optim import compress as jcomp
from repro_torch import convert
from repro_torch.optim import adamw as opt
from repro_torch.optim import compress
from torch_parity import HERE, world_mesh

RNG = np.random.default_rng(23)
TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}


def f32(a) -> np.ndarray:
    """An array as float32; the port's bfloat16 arrives as uint16 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def close(got, want, rel):
    got, want = f32(convert.to_numpy(got) if isinstance(got, torch.Tensor) else got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


def tt(a) -> torch.Tensor:
    return convert.to_tensor(np.asarray(a), "cpu")


# ---------------------------------------------------------- schedule, clip


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 1), (200, 10000), (5, 5)])
def test_lr_at_matches_repro(warmup, total):
    jc = jopt.OptConfig(peak_lr=3e-4, warmup_steps=warmup, total_steps=total)
    tc = opt.OptConfig(peak_lr=3e-4, warmup_steps=warmup, total_steps=total)
    assert float(opt.lr_at(0, tc)) == 0.0 or warmup == 0
    for step in [0, 1, warmup // 2, warmup, warmup + 1, (warmup + total) // 2, total, 2 * total]:
        want = float(jopt.lr_at(jnp.int32(step), jc))
        assert float(opt.lr_at(step, tc)) == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_clip_by_global_norm_matches_repro(max_norm):
    grads = {"a": RNG.standard_normal((7, 5)).astype(np.float32),
             "b": RNG.standard_normal(11).astype(np.float32) * 30}
    jclipped, jnorm = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()},
                                               max_norm)
    clipped, norm = opt.clip_by_global_norm({k: tt(v) for k, v in grads.items()}, max_norm)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    for k in grads:
        close(clipped[k], jclipped[k], 1e-6)
    inplace = {k: tt(v).clone() for k, v in grads.items()}
    opt.clip_by_global_norm(inplace, max_norm, inplace=True)
    for k in grads:
        assert torch.equal(inplace[k], clipped[k])


# ------------------------------------------------------------------- AdamW


def _run_both(params: dict, grads_per_step: list, cfg_kw: dict, *, groups=None,
              jparams=None, to_port=None):
    """Run ``repro``'s and the port's optimizer over the same steps; returns
    (repro's params and state, the port's params and state)."""
    jc, tc = jopt.OptConfig(**cfg_kw), opt.OptConfig(**cfg_kw)
    jparams = jparams or {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: tt(v).clone() for k, v in (to_port(jparams) if to_port else params).items()}
    jstate = jopt.init_opt_state(jparams, jc)
    tstate = opt.init_opt_state(tparams, tc, groups)
    for step, grads in enumerate(grads_per_step):
        jparams, jstate, jnorm = jopt.apply_updates(
            jparams, jax.tree.map(jnp.asarray, grads), jstate, jnp.int32(step), jc)
        tg = {k: tt(v) for k, v in (to_port(grads) if to_port else grads).items()}
        _, _, norm = opt.apply_updates(tparams, tg, tstate, step, tc, groups)
        assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    return (jparams, jstate), (tparams, tstate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_repro(dtype):
    """Five steps (lr(0) == 0, warmup, cosine) on leaves of several ranks;
    bfloat16 parameters, gradients and states as tests/test_optim.py has
    them."""
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    shapes = {"w": (16, 24), "b": (24,), "e": (3, 4, 5), "s": (1,)}
    params = {k: (RNG.standard_normal(s) * 0.5).astype(np_dt) for k, s in shapes.items()}
    grads = [{k: (RNG.standard_normal(s) * 10.0 ** RNG.integers(-3, 2)).astype(np_dt)
              for k, s in shapes.items()} for _ in range(5)]
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=6, state_dtype=dtype)
    (jp, js), (tp, ts) = _run_both(params, grads, kw)
    for k in shapes:
        assert tp[k].dtype == getattr(torch, dtype) and ts["m"][k].dtype == getattr(torch, dtype)
        close(tp[k], jp[k], TOL[dtype])
        close(ts["m"][k], js["m"][k], TOL[dtype])
        close(ts["v"][k], js["v"][k], TOL[dtype])


# --------------------------------------------------------------- Adafactor


def _stacked_case(count: int):
    """``repro``'s tree with a stacked segment of ``count`` layers (a leaf
    factored on its last two dims, a 1-D leaf, a (count, 4, 4) leaf below
    factored_min_dim) and an unstacked factored leaf; the port's names."""
    seg = {"w": RNG.standard_normal((count, 8, 16)).astype(np.float32),
           "s": RNG.standard_normal((count, 16)).astype(np.float32),
           "t": RNG.standard_normal((count, 2, 4)).astype(np.float32)}
    tree = {"embed": {"table": RNG.standard_normal((8, 12)).astype(np.float32)},
            "segments": [(seg,)]}
    cfg = types.SimpleNamespace(segments=(((None,), count),))
    groups = [tuple(f"layers.{c}.{k}" for c in range(count)) for k in seg]
    return tree, cfg, groups


@pytest.mark.parametrize("count", [1, 2])
def test_adafactor_matches_repro_on_stacked_segments(count):
    """``repro`` decides factoring on the stacked (count, ...) leaf and clips
    the update's RMS over all of it; the port holds one tensor per layer and
    groups them as ``repro`` stacks them. Without the groups the clip is
    taken per layer and the update differs (count 2)."""
    tree, cfg, groups = _stacked_case(count)

    def grads():
        return jax.tree.map(lambda a: (RNG.standard_normal(a.shape) * 3).astype(np.float32),
                            tree)

    steps = [grads() for _ in range(4)]
    to_port = lambda t: convert.params_from_jax(cfg, jax.tree.map(np.asarray, t))
    kw = dict(name="adafactor", peak_lr=0.05, warmup_steps=1, total_steps=8,
              factored_min_dim=4)
    (jp, js), (tp, ts) = _run_both(None, steps, kw, groups=groups,
                                   jparams=jax.tree.map(jnp.asarray, tree), to_port=to_port)
    want_p = to_port(jp)
    want_s = convert.opt_state_from_jax(cfg, jax.tree.map(np.asarray, js))
    assert set(ts["v"]["layers.0.w"]) == {"vr", "vc"} and set(ts["v"]["embed.table"]) == {
        "vr", "vc"}
    assert set(ts["v"]["layers.0.s"]) == {"v"} and set(ts["v"]["layers.0.t"]) == {"v"}
    for k, want in want_p.items():
        close(tp[k], want, 1e-6)
        for kind, s in want_s["v"][k].items():
            close(ts["v"][k][kind], s, 1e-6)
    if count > 1:  # the trap: per-layer clipping gives another update
        _, (ungrouped, _) = _run_both(None, steps, kw, groups=None,
                                      jparams=jax.tree.map(jnp.asarray, tree), to_port=to_port)
        diff = max(float((ungrouped[k] - tp[k]).abs().max()) for k in tp)
        assert diff > 1e-4


def test_adafactor_factors_on_the_stacked_shape():
    """A 1-D per-layer leaf that ``repro`` stacks into a factored
    (count, d) leaf cannot be split per layer: the port refuses it."""
    cfg = opt.OptConfig(name="adafactor", factored_min_dim=4)
    params = {f"layers.{i}.s": torch.zeros(16) for i in range(4)}
    groups = [tuple(params)]
    jst = jopt.init_opt_state({"s": jnp.zeros((4, 16))}, jopt.OptConfig(**{
        "name": "adafactor", "factored_min_dim": 4}))
    assert set(jst["v"]["s"]) == {"vr", "vc"}
    with pytest.raises(NotImplementedError, match="do not split per layer"):
        opt.init_opt_state(params, cfg, groups)
    assert set(opt.init_opt_state(params, cfg)["v"]["layers.0.s"]) == {"v"}


def test_segment_groups_follow_repro_stacking():
    """``segment_groups`` names, for every stacked leaf of ``repro``'s tree,
    the per-layer tensors ``params_from_jax`` splits it into, in order."""
    import dataclasses

    from repro.configs.registry import smoke_config as jsmoke
    from repro.models.model import Model as JModel
    from repro_torch.configs.registry import smoke_config

    dense, moe = jsmoke("deepseek-moe-16b").segments[0][0], jsmoke(
        "deepseek-moe-16b").segments[1][0]
    segs = ((dense, 1), (moe, 3))
    jc = dataclasses.replace(jsmoke("deepseek-moe-16b"), segments=segs, n_layers=4)
    tc = dataclasses.replace(smoke_config("deepseek-moe-16b"), segments=tuple(
        (tuple(type(s)(**dataclasses.asdict(s)) for s in p), c) for p, c in segs), n_layers=4)
    params = jax.eval_shape(lambda: JModel(jc).init(jax.random.key(0)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), params)
    names = convert.params_from_jax(tc, zeros)
    groups = opt.segment_groups(tc, names)
    stacked = [a for seg in zeros["segments"] for _, a in convert._leaves(seg[0])]
    assert len(groups) == len(stacked)
    assert sorted(len(g) for g in groups) == sorted(a.shape[0] for a in stacked)
    assert ("layers.1.moe.wi", "layers.2.moe.wi", "layers.3.moe.wi") in groups
    assert ("layers.0.mlp.wi",) in groups
    assert all(n.startswith("layers.") for g in groups for n in g)


# ------------------------------------------------------------ compression


def _quant_input(n_chunks: int = 64) -> np.ndarray:
    x = RNG.standard_normal(compress.CHUNK * n_chunks).astype(np.float32)
    x[: compress.CHUNK] = 0.0  # an all-zero chunk: scale 1e-12
    # halves after scaling: round-half-to-even on both sides
    chunk = x[compress.CHUNK:2 * compress.CHUNK]
    chunk[:] = np.arange(compress.CHUNK) % 9 - 4.5
    chunk[0] = 127.0
    return x


def test_int8_quantization_matches_repro_bit_for_bit():
    x = _quant_input()
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    q, s = compress.quantize_int8(tt(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    y, jy = compress.dequantize_int8(q, s), jcomp.dequantize_int8(jq, js)
    np.testing.assert_array_equal(y.numpy().view(np.uint32), np.asarray(jy).view(np.uint32))
    # the quantizer's error bound on the normal chunks, as tests/test_optim.py states it
    x, y = x[2 * compress.CHUNK:], y.numpy()[2 * compress.CHUNK:]
    rms = float(np.sqrt(np.mean((x - y) ** 2)) / np.sqrt(np.mean(x ** 2)))
    assert rms < 0.01


def test_compressed_psum_mean_one_rank_matches_repro():
    """One rank: the mean is the rank's own x, quantized and dequantized;
    ``repro``'s under ``shard_map`` over one device gives the same bits."""
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.sharding.spec import shard_map_compat

    x = _quant_input(8)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want = shard_map_compat(lambda v: jcomp.compressed_psum_mean(v, "data"), mesh=mesh,
                            in_specs=P(), out_specs=P())(jnp.asarray(x))
    got = compress.compressed_psum_mean(tt(x), (world_mesh(), "data"))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))


def test_compressed_psum_mean_two_gloo_ranks(tmp_path):
    """Two gloo ranks (tests/torch_mesh_worker.py ... compress): each holds
    the mean of both ranks' x, equal bit for bit to ``repro``'s quantizer
    on (x0 + x1) / 2 (two addends sum the same in any order)."""
    import os

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_mesh_worker.py"), str(r), "2",
                               str(tmp_path / "store"), str(tmp_path), "compress"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    xs = [np.load(tmp_path / f"rank{r}.npz")["x"] for r in range(2)]
    q, s = jcomp.quantize_int8((jnp.asarray(xs[0]) + jnp.asarray(xs[1])) / 2)
    want = np.asarray(jcomp.dequantize_int8(q, s))
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")["mean"]
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
