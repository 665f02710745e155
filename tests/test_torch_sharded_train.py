"""Sharded training of the port on 4 gloo CPU ranks against ``repro``'s
one-device train step.

``repro``'s own sharded step does not run on jax 0.9 (its vocab-sharded
embedding raises ShardingTypeError: ROADMAP.md §3), and sharding changes
no arithmetic where nothing drops, so the oracle is ``repro``'s one-device
``make_train_step``: one step (lr warming up, grad_accum 2, remat on,
float32, AdamW) of the qwen3-4b and deepseek-moe-16b smoke configs
(capacity factor 8: nothing drops) from ``repro``'s weights, carried to
the ranks by ``convert.params_from_jax`` and ``convert.shard_state``, on
one seeded batch with ignored labels. The ranks
(tests/torch_sharded_worker.py, started once for the module) run the
meshes (data, model) = (1, 4), (2, 2) with experts over ("data",
"model") (ZeRO-1 over "data"), and (pod, data, model) = (2, 1, 2); and the
qwen3-4b config with 6 heads on model = 4, which ``Axes.pad_heads`` pads
to 8, against ``repro``'s unsharded step over its padded parameters
(``repro``'s forward takes H from the shape). Loss, grad norm, every
parameter and AdamW's m and v, gathered, within rtol = atol = 2e-5;
where a gradient is at the noise floor (its m under 1e-6 of the model's
largest |m|: both sides hold rounding residue of about 1e-10 there, of
either sign), Adam's normalized step turns it into a move of up to lr,
so such a parameter is held to lr.

The MoE aux loss is off there: token-parallel routing averages the aux of
each rank's block over the mesh (``repro``'s ``pmean``), a different
function from the one-device aux over all tokens. With the aux on, the
(2, 2) step is held, at the same tolerance, to the one-rank port whose
MoE aux is that mean of the four blocks' aux: this checks the aux mean's
backward. Besides: a sharded model's blocks are the one-rank model's
from the same seed, bit for bit; replicated leaves are the same bits on
every replica after the step; the vocab-parallel cross-entropy and
embedding against the one-rank ones; a per-rank checkpoint round trip and
the ValueError on another mesh shape; the dry run, which a mesh does not
run yet, raises naming its ROADMAP.md item, and what item 11.2 ported
builds and steps on a one-rank mesh.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_worker as W
from repro.configs.registry import smoke_config as jsmoke
from repro.models.model import Model as JModel
from repro.optim.adamw import OptConfig as JOptConfig
from repro.optim.adamw import init_opt_state as jinit_opt
from repro.sharding.spec import Axes as JAxes
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models import model as model_lib
from repro_torch.sharding.spec import Axes

HERE = pathlib.Path(__file__).resolve().parent
WORLD = 4
ACCUM, B, S = 2, 4, 64
TOL = 2e-5
TIMEOUT_S = 240  # the ranks' collectives time out at 120 s


def _batch(vocab) -> dict:
    rng = np.random.default_rng(41)
    batch = {"tokens": rng.integers(0, vocab, (ACCUM, B, S)).astype(np.int32),
             "labels": rng.integers(0, vocab, (ACCUM, B, S)).astype(np.int32)}
    batch["labels"][0, 0, :5] = -1
    batch["labels"][1, 3, -9:] = -1
    return batch


def _repro_side(d: pathlib.Path) -> dict:
    """``repro``'s initial weights (written as the port's ``state_dict``,
    ``init_<config>.pt``) and its state after one step, per config."""
    want = {}
    for name, (arch, kw) in W.CONFIGS.items():
        cfg = dataclasses.replace(jsmoke(arch), dtype="float32", remat=True,
                                  moe_capacity_factor=8.0, **kw)
        tc = W.config(name)
        axes = JAxes(mesh_shape={"data": 1, "model": 4}) if "n_heads" in kw else None
        params = JModel(cfg, axes).init(jax.random.key(3))  # heads padded with axes
        torch.save(convert.params_from_jax(tc, jax.tree.map(np.asarray, params)),
                   d / f"init_{name}.pt")
        tcfg = JTrainConfig(opt=JOptConfig(**W.OPT), aux_coef=0.0)
        ost = jinit_opt(params, tcfg.opt)
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab).items()}
        p, o, m = jax.jit(jmake_step(JModel(cfg), tcfg))(params, ost, jnp.int32(W.STEP), batch)
        p, o, m = jax.tree.map(np.asarray, (p, o, m))
        want[name] = {"metrics": {k: float(v) for k, v in m.items()},
                      "params": convert.params_from_jax(tc, p),
                      **convert.opt_state_from_jax(tc, o)}
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_train")
    np.savez(d / "batch.npz", **_batch(smoke_config("qwen3-4b").vocab))
    want = _repro_side(d)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE), os.environ.get("PYTHONPATH", "")]))
    logs = [open(d / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_sharded_worker.py"), str(r),
                               str(WORLD), str(d / "store"), str(d)], env=env, stdout=f,
                              stderr=subprocess.STDOUT) for r, f in enumerate(logs)]
    deadline = time.monotonic() + TIMEOUT_S
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
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join((d / f"rank{r}.log").read_text()[-3000:] for r in bad)
    return want, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for n in want:
        np.testing.assert_allclose(np.asarray(got[n], np.float32), np.asarray(want[n], np.float32),
                                   rtol=TOL, atol=TOL, err_msg=f"{what} {n}")


def _np(t) -> np.ndarray:
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t, np.float32)


def _hold(got: dict, want: dict, aux: bool = True) -> None:
    """``aux``: compare the aux metric (not where the two sides define it
    differently: module docstring)."""
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        if aux or k != "aux":
            assert got["metrics"][k] == pytest.approx(v, rel=TOL, abs=TOL), k
    for kind in ("m", "v"):
        _close({n: _np(t) for n, t in got[kind].items()},
               {n: _np(t) for n, t in want[kind].items()}, kind)
    floor = 1e-6 * max(float(np.abs(_np(t)).max()) for t in want["m"].values())
    lr = want["metrics"]["lr"]
    assert set(got["params"]) == set(want["params"])
    for n, t in want["params"].items():
        a, b = _np(got["params"][n]), _np(t)
        live = np.abs(_np(want["m"][n])) >= floor
        np.testing.assert_allclose(a[live], b[live], rtol=TOL, atol=TOL, err_msg=n)
        assert float(np.abs(a - b)[~live].max(initial=0.0)) <= lr, n


@pytest.mark.parametrize("case", list(W.CASES))
def test_sharded_step_matches_repro(runs, case):
    want, ranks = runs
    cname, _ = W.CASES[case]
    for r, got in enumerate(ranks):
        _hold(got[case], want[cname], aux=cname != "moe")
        assert got[case]["replicas_equal"], r


def test_each_rank_steps_on_its_block(runs):
    """The batch over the batch axes (B = 4 over data 2, or pod 2), the
    sequence whole on each rank of "model"."""
    _, ranks = runs
    assert ranks[0]["qwen3/1x4"]["local_tokens"] == (ACCUM, B, S)
    assert ranks[0]["qwen3/2x2"]["local_tokens"] == (ACCUM, B // 2, S)
    assert ranks[0]["qwen3/2x1x2"]["local_tokens"] == (ACCUM, B // 2, S)


def test_aux_mean_backward_matches_its_oracle(runs):
    _, ranks = runs
    for got in ranks:
        _hold(got["aux"]["sharded"], got["aux"]["oracle"])
        assert got["aux"]["sharded"]["metrics"]["aux"] > 0


def test_sharded_draws_are_the_one_rank_models(runs):
    """A rank draws each leaf whole and keeps its block: gathered, the
    blocks are the one-rank model from the same seed, bit for bit; a rank
    holds less than a third of the model (experts and heads over 4 or 2)."""
    _, ranks = runs
    for got in ranks:
        for name, r in got["draws"].items():
            assert r["equal"], name
            assert r["local_elems"] * 2 < r["whole_elems"], name


def test_vocab_parallel_cross_entropy_and_embedding(runs):
    """On (2, 2): the logits' rows over "data", the vocabulary over
    "model" (the last block holds the padded columns and a label beside
    them). The shares summed over "data" are the one-rank loss; the
    metrics are the global batch's; each block's gradient is the one-rank
    gradient's block. The embedding's lookup and gradient, bit for bit."""
    _, ranks = runs
    for got in ranks:
        ce = got["pieces"]["ce"]
        assert ce["loss"][0] == pytest.approx(ce["loss"][1], rel=1e-6)
        for k, (a, b) in ce["metrics"].items():
            assert a == pytest.approx(b, rel=1e-6, abs=1e-7), k
        assert ce["grad_err"] <= 1e-6 * ce["grad_max"]
        assert got["pieces"]["embed"] == {"equal": True, "grad_equal": True}


def test_per_rank_checkpoint_and_another_mesh_shape(runs):
    _, ranks = runs
    for got in ranks:
        ck = got["pieces"]["ckpt"]
        assert ck["step"] == 3 and ck["equal"]
        msg = ck["other_mesh"]
        assert msg is not None and "{'data': 2, 'model': 2}" in msg
        assert "{'data': 1, 'model': 4}" in msg


@pytest.mark.parametrize("arch,item", [("dryrun", "item 11.4")])
def test_what_a_mesh_does_not_run_names_its_item(arch, item):
    """The dry run (item 11.4) is still to port; every mixer, the encoder,
    cross-attention and Adafactor run under a mesh (item 11.2:
    ``test_what_a_mesh_runs_now``)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import _LATER

    assert set(_LATER) == {"dryrun"}
    with pytest.raises(NotImplementedError, match=item):
        dryrun.main([])


def _one_rank_axes():
    """``Axes`` of a (data, model) = (1, 1) mesh over this process's
    one-rank gloo group: the sharded paths, with no peer."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.sharding import spec
    from torch_parity import world_mesh

    world_mesh()
    return spec.from_mesh(DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                                     mesh_dim_names=("data", "model")))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "falcon-mamba-7b", "recurrentgemma-9b",
                                  "whisper-base", "llama-3.2-vision-11b", "adafactor",
                                  "mla_decode", "window_decode", "cross_decode"])
def test_what_a_mesh_runs_now(arch):
    """What a mesh refused before item 11.2 builds and runs on one: each
    config (its own optimizer: deepseek-v3's Adafactor, the others' AdamW)
    takes a train step on a one-rank (1, 1) mesh, qwen3-4b with Adafactor
    too, and an MLA, windowed or cross model prefills and decodes there
    with ``seq_shard``. Four ranks against ``repro``: tests/
    test_torch_tp_mixers.py and tests/test_torch_sharded_adafactor.py."""
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.serve import engine
    from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

    axes = _one_rank_axes()
    source = {"adafactor": "qwen3-4b", "mla_decode": "deepseek-v3-671b",
              "window_decode": "recurrentgemma-9b", "cross_decode": "whisper-base"}
    cfg = dataclasses.replace(smoke_config(source.get(arch, arch)), dtype="float32")
    if arch == "adafactor":
        cfg = dataclasses.replace(cfg, optimizer="adafactor")
    model = model_lib.Model(cfg, axes=axes, device="cpu", seed=2)
    assert model.sharded
    rng = np.random.default_rng(5)
    memory = {}
    if cfg.encoder_segments:
        memory["frames"] = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    if cfg.n_vision_tokens:
        memory["vision"] = rng.standard_normal((2, cfg.n_vision_tokens, cfg.d_model)).astype(
            np.float32)
    if arch.endswith("_decode"):
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)),
                 **{k: torch.from_numpy(v) for k, v in memory.items()}}
        toks = engine.generate(model, batch, 3, seq_shard=True)
        assert toks.shape == (2, 3)
        return
    tcfg = TrainConfig(opt=OptConfig(name=cfg.optimizer, state_dtype=cfg.opt_state_dtype,
                                     **W.OPT))
    params, ost = init_train_state(model, tcfg)
    batch = {"tokens": rng.integers(0, cfg.vocab, (1, 2, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (1, 2, 16)).astype(np.int32),
             **{k: v[None] for k, v in memory.items()}}
    _, _, metrics = make_train_step(model, tcfg)(params, ost, 1, batch)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0


def test_qwen3_and_deepseek_moe_train_under_a_mesh():
    """Every config's sharded model builds (its shapes on the meta device)
    on a (2, 4) mesh: nothing is refused."""
    for arch in ("qwen3-4b", "deepseek-moe-16b", "qwen2.5-32b", "starcoder2-7b",
                 "deepseek-v3-671b", "falcon-mamba-7b", "recurrentgemma-9b", "whisper-base",
                 "llama-3.2-vision-11b"):
        model_lib.Model(smoke_config(arch), axes=Axes(mesh_shape={"data": 2, "model": 4}),
                        device="meta")
    assert Axes(mesh_shape={"data": 2, "model": 4}).batch_size == 2


def _launch(d: pathlib.Path, *runs) -> list:
    """Each run, (tag, argv), is ``python -m repro_torch.launch.train`` on
    WORLD ranks of the CPU, as ``torchrun`` starts them (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT), on gloo; the runs at the same
    time. Returns each run's ranks' output lines."""
    started = [_start(d, tag, *argv) for tag, argv in runs]
    return [_wait(*s) for s in started]


def _start(d: pathlib.Path, tag: str, *argv):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(WORLD), PYTHONPATH=os.pathsep.join(
                    [str(HERE.parent / "src"), os.environ.get("PYTHONPATH", "")]))
    outs = [(d / f"{tag}{r}.out", d / f"{tag}{r}.err") for r in range(WORLD)]
    files = [(open(o, "w"), open(e, "w")) for o, e in outs]
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *argv],
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), stdout=f,
                              stderr=e) for r, (f, e) in enumerate(files)]
    return procs, files, outs


def _wait(procs, files, outs) -> list:
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f[0].close()
            f[1].close()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        e.read_text()[-3000:] for _, e in outs)
    return [o.read_text().splitlines() for o, _ in outs]


def test_launcher_trains_saves_and_resumes_on_four_ranks(tmp_path):
    """The deepseek-moe-16b smoke config on make_mesh_for(4) = (1, 4):
    rank 0 prints ``repro``'s lines, the others nothing; each rank saves
    its blocks; a run resumed at step 2 loads the batches from there, so
    its step-2 line is the uninterrupted run's."""
    args = ["--device", "cpu", "--dist-backend", "gloo", "--arch", "deepseek-moe-16b",
            "--seq-len", "32", "--global-batch", "4", "--log-every", "1"]
    full, _ = _launch(tmp_path,
                      ("full", [*args, "--steps", "3", "--ckpt-dir", str(tmp_path / "a")]),
                      ("first", [*args, "--steps", "2", "--save-every", "2",
                                 "--ckpt-dir", str(tmp_path / "b")]))
    (resumed,) = _launch(tmp_path, ("again", [*args, "--steps", "1", "--resume",
                                              "--ckpt-dir", str(tmp_path / "b")]))
    cfg = smoke_config("deepseek-moe-16b")
    assert full[0][0] == f"[train] deepseek-moe-16b: {cfg.param_count():,} params on 4 device(s)"
    assert all(lines == [] for ranks in (full, resumed) for lines in ranks[1:])
    assert resumed[0][1] == "[train] resumed from step 2"
    step2 = [line for line in full[0] if line.startswith("[train] step 2:")]
    assert step2 and resumed[0][2].split(" (")[0] == step2[0].split(" (")[0]
    assert resumed[0][-1].startswith("[train] done at step 3;")
    ckpt = tmp_path / "b" / "step_000000002"
    assert sorted(p.name for p in ckpt.iterdir() if p.name.startswith("arrays_")) == [
        f"arrays_{r}.npz" for r in range(WORLD)]
