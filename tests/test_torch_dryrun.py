"""The port's dry run (``launch/dryrun.py``, ``launch/hlo_stats.py``)
against ``repro``'s counts and against real ranks, on the CPU.

* FLOPs: ``hlo_stats.Counts`` on the meta device equals ``repro``'s
  ``hlo_stats.aggregate(compiled.as_text())["dot_flops"]`` exactly, on
  the same one-device program (``repro`` lowers and compiles it on jax
  0.9): prefill of 2 x 64 and one decode step over a 128-long cache for
  the ten smoke configs, and a train step of 2 x 64 for four of them,
  remat on and off. The flops also equal ``FlopCounterMode``'s.
* Traffic within 0.5-2x of ``repro``'s on the same programs (the ratios
  are in PERF.md: ``repro``'s CPU backend counts a bfloat16 product's
  operands in float32, so the ratio of a bfloat16 model sits near 0.5).
* The meta count equals the CPU count of the same program, FLOPs and
  kernel calls (the kernels' fakes against their twins).
* Collective bytes: four gloo ranks (``tests/torch_dryrun_worker.py``)
  run a (2, 2) train step and prefill of the qwen3-4b and
  deepseek-moe-16b smoke configs with every ``AxisGroup`` collective
  recording the bytes it returns; rank 0's bytes by kind equal the
  ``CountingMesh``'s, and one GQA prefill's equal an analytic count.
* The flash op's FLOP formula against a brute-force count of the kept
  (query, key) pairs, causal and not.
* One production cell through ``dryrun.main``: whisper-base ``train_4k``
  on 16 x 16, as ``repro``'s tests/test_dryrun.py asserts.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import torch_dryrun_worker as W
from repro.configs.registry import smoke_config as jsmoke
from repro.launch import hlo_stats as jstats
from repro.models.model import Model as JModel
from repro.models.model import abstract_params
from repro.optim import adamw as jopt
from repro.serve.engine import make_prefill as jprefill
from repro.serve.engine import make_serve_step as jserve_step
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as jmake_step
from repro_torch.configs.registry import ARCH_IDS, smoke_config
from repro_torch.kernels import flash
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.models import attention
from repro_torch.sharding.spec import CountingMesh

HERE = pathlib.Path(__file__).resolve().parent
B, S, CACHE = 2, 64, 128
TRAIN_ARCHS = ("qwen3-4b", "deepseek-moe-16b", "deepseek-v3-671b", "falcon-mamba-7b")
WORLD, TIMEOUT_S = 4, 240


def _configs(arch, **kw):
    return dataclasses.replace(jsmoke(arch), **kw), dataclasses.replace(smoke_config(arch), **kw)


def _shape(kind):
    return (CACHE, B, "decode") if kind == "decode" else (S, B, kind)


@functools.lru_cache(maxsize=None)
def _repro(arch, kind, remat=False) -> dict:
    """``repro``'s ``aggregate`` of the compiled one-device program: the
    inputs as ``dryrun.input_specs`` makes them (whisper's frames as long
    as the tokens, the decode cache's memory as long as the cache)."""
    jc, _ = _configs(arch, remat=remat)
    jm = JModel(jc)
    ap = abstract_params(jc)
    sds = jax.ShapeDtypeStruct
    dt = jnp.dtype(jc.dtype)
    if kind == "train":
        tcfg = JTrainConfig(opt=jopt.OptConfig(name=jc.optimizer,
                                               state_dtype=jc.opt_state_dtype))
        astate = jax.eval_shape(lambda p: jopt.init_opt_state(p, tcfg.opt), ap)
        batch = {"tokens": sds((1, B, S), jnp.int32), "labels": sds((1, B, S), jnp.int32)}
        if jc.encoder_segments:
            batch["frames"] = sds((1, B, S, jc.d_model), dt)
        if jc.n_vision_tokens:
            batch["vision"] = sds((1, B, jc.n_vision_tokens, jc.d_model), dt)
        lowered = jax.jit(jmake_step(jm, tcfg)).lower(ap, astate, sds((), jnp.int32), batch)
    elif kind == "prefill":
        batch = {"tokens": sds((B, S), jnp.int32)}
        if jc.encoder_segments:
            batch["frames"] = sds((B, S, jc.d_model), dt)
        if jc.n_vision_tokens:
            batch["vision"] = sds((B, jc.n_vision_tokens, jc.d_model), dt)
        lowered = jax.jit(jprefill(jm)).lower(ap, batch)
    else:
        mem = CACHE if jc.encoder_segments else jc.n_vision_tokens
        caches = jax.eval_shape(lambda: jm.init_caches(B, CACHE, memory_len=mem))
        lowered = jax.jit(jserve_step(jm)).lower(ap, caches, sds((B, 1), jnp.int32),
                                                 sds((), jnp.int32))
    return jstats.aggregate(lowered.compile().as_text())


def _port(arch, kind, remat=False, device="meta") -> dict:
    _, cfg = _configs(arch, remat=remat)
    return dryrun.run_counted(cfg, _shape(kind), device=device)


SMOKE = [(arch, kind, False) for kind in ("prefill", "decode") for arch in ARCH_IDS]
SMOKE += [(arch, "train", True) for arch in TRAIN_ARCHS]
# the train steps without remat, marked slow to keep this file within a
# minute of the tier-1 run (each compiles a train step of repro's)
SMOKE += [pytest.param(arch, "train", False, marks=pytest.mark.slow) for arch in TRAIN_ARCHS]


@pytest.mark.parametrize("arch,kind,remat", SMOKE)
def test_flops_equal_repro_and_traffic_within_a_factor_of_two(arch, kind, remat):
    want = _repro(arch, kind, remat)
    got = _port(arch, kind, remat)
    assert got["dot_flops"] == want["dot_flops"]
    ratio = got["traffic"] / want["traffic"]
    print(f"traffic {arch} {kind} remat={remat}: port {got['traffic']:.0f}, "
          f"repro {want['traffic']:.0f}, ratio {ratio:.3f}")
    assert 0.5 <= ratio <= 2.0
    assert got["colls"] == {} and got["peak_bytes"] > got["args_bytes"] > 0


@pytest.mark.parametrize("arch,kind", [("qwen3-4b", "train"), ("deepseek-moe-16b", "prefill"),
                                       ("whisper-base", "prefill")])
def test_counts_agree_with_flop_counter_mode(arch, kind):
    """``Counts`` applies the formulas ``FlopCounterMode`` counts with."""
    _, cfg = _configs(arch)
    with FlopCounterMode(display=False) as fc:
        got = dryrun.run_counted(cfg, _shape(kind))
    assert got["dot_flops"] == fc.get_total_flops()


@pytest.mark.parametrize("arch,kind", [("deepseek-moe-16b", "prefill"),
                                       ("deepseek-moe-16b", "train"),
                                       ("qwen3-4b", "prefill"), ("deepseek-v3-671b", "decode")])
def test_meta_count_equals_the_cpu_count(arch, kind, monkeypatch):
    """The kernels' fakes on meta and their twins on the CPU: the same
    FLOPs and calls of each kernel op (qwen3-4b's prefill through flash,
    ``FLASH_MIN_SEQ`` lowered to 32; the MoE dispatch's kv sort)."""
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 32)
    _, cfg = _configs(arch, flash_attention=True, dtype="float32")
    meta = dryrun.run_counted(cfg, _shape(kind))
    cpu = dryrun.run_counted(cfg, _shape(kind), device="cpu")
    assert meta["dot_flops"] == cpu["dot_flops"] and meta["kernels"] == cpu["kernels"]
    assert meta["traffic"] == cpu["traffic"]
    if arch == "qwen3-4b":
        assert cpu["kernels"] == {"flash_attention": cfg.n_layers}
    if arch == "deepseek-moe-16b":
        assert cpu["kernels"]["sort_rows_kv"] >= 1  # 256 assignments: one tile, no merge


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_ranks")
    path = os.pathsep.join([str(HERE.parent / "src"), str(HERE),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        log = open(d / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(HERE / "torch_dryrun_worker.py"), str(r), str(WORLD),
             str(d / "store"), str(d)], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join((d / f"rank{r}.log").read_text()[-3000:] for r in bad)
    return json.loads((d / "rank0.json").read_text())


def _counted(case) -> dict:
    arch, cell = W.CASES[case]
    return dryrun.run_counted(W.config(arch), cell, mesh=CountingMesh(*W.MESH), seed=3)


@pytest.mark.parametrize("case", W.CASES)
def test_collective_bytes_equal_what_gloo_ranks_moved(gloo_ranks, case):
    """Rank 0's bytes by kind, recorded on the real groups, against the
    counting group's; the FLOPs and kernel calls too."""
    got = _counted(case)
    want = gloo_ranks[case]
    assert got["colls"] == want["colls"] and got["coll_bytes"] > 0
    assert got["dot_flops"] == want["dot_flops"] and got["kernels"] == want["kernels"]


def test_gqa_prefill_collective_bytes_match_the_analytic_count():
    """qwen3-4b's smoke prefill (float32, 2 x 32 on (data, model) = (2,
    2)): each rank takes 1 row. The vocab-parallel embedding sums its
    (1, 32, d) lookups over "model", and so does each layer's attention
    output and MLP output (row-parallel products); the head's logits of
    the last position, (1, 1, Vp / 2) a rank, are gathered over "model".
    Nothing else moves."""
    cfg = W.config("qwen3-4b")
    got = dryrun.run_counted(cfg, (32, 4, "prefill"), mesh=CountingMesh(*W.MESH))
    rows, f32 = 4 // 2, 4
    d, L, Vp = cfg.d_model, cfg.n_layers, 512  # the smoke vocab, a multiple of 128
    assert got["colls"] == {"all-reduce": (1 + 2 * L) * rows * 32 * d * f32,
                            "all-gather": 2 * rows * 1 * (Vp // 2) * f32}


@pytest.mark.parametrize("S,T", [(1, 1), (7, 7), (5, 9), (9, 5), (64, 64), (40, 24)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_flop_formula_counts_the_kept_pairs(S, T, causal):
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(T)[None, :]
    kept = int((qpos >= kpos).sum()) if causal else S * T
    assert flash.kept_pairs(S, T, causal) == kept
    Bq, H, KV, dqk, dv = 2, 4, 2, 192, 128
    q = torch.empty((Bq, S, H, dqk), device="meta")
    k = torch.empty((Bq, T, KV, dqk), device="meta")
    v = torch.empty((Bq, T, KV, dv), device="meta")
    with hlo_stats.Counts() as c, FlopCounterMode(display=False) as fc:
        out = flash.flash_attention(q, k, v, causal=causal)
    assert out.shape == (Bq, S, H, dv) and out.device.type == "meta"
    assert c.flops == fc.get_total_flops() == 2 * Bq * H * (dqk + dv) * kept
    assert c.kernels == {"flash_attention": 1}


def test_production_cell_through_main(tmp_path):
    """``repro``'s tests/test_dryrun.py cell: whisper-base train_4k on the
    16 x 16 production mesh, counted on meta."""
    dryrun.main(["--arch", "whisper-base", "--shape", "train_4k", "--out", str(tmp_path)])
    got = json.loads((tmp_path / "whisper-base_train_4k_single.json").read_text())
    assert got["devices"] == 256
    assert got["flops_per_device"] > 1e9
    assert got["collective_bytes_per_device"] > 0
    assert got["bytes_per_device_gb"] > 0
    assert set(got["memory_detail"]) >= {"args_gb", "temp_gb"}


def test_an_opt_flag_the_config_lacks_is_refused():
    with pytest.raises(ValueError, match="no_such_switch"):
        dryrun.opt_config(smoke_config("qwen3-4b"), "qwen3-4b", ("no_such_switch",))
    cfg, seq_shard = dryrun.opt_config(smoke_config("qwen3-4b"), "qwen3-4b", dryrun.OPT2_FLAGS)
    assert seq_shard and cfg.flash_attention and cfg.hierarchical_a2a and cfg.decode_moe_ep
