"""Adafactor with ZeRO-1 on 4 gloo CPU ranks against ``repro``'s
one-device train step (its ``apply_updates``).

The configs are the float32 smoke deepseek-v3-671b (MLA, dense and MoE)
and falcon-mamba-7b with every segment two layers deep, so that ``repro``
stacks each leaf as (2, ...) and the relative step clip runs over both
layers (``optim.adamw.segment_groups``), and Adafactor factoring from 16
columns (``factored_min_dim``), so that the smoke widths factor: MLA's
projections take ``vr`` / ``vc``, Mamba's ``A_log`` (di, 8) and the
norms the unfactored ``v``. The ranks (tests/torch_tp_mixers_worker.py
``adafactor``) take two steps (steps 1 and 2: the second reads the first's
states) on (data, model) = (1, 4) and (2, 2) (2-D experts) with float32
states; after each, the loss, the grad norm, every parameter and every
``vr`` / ``vc`` / ``v``, gathered, within 1e-5 x the largest |value| of
``repro``'s, replicated leaves the same bits on every replica, and the
gathered states cut again by ``convert.shard_state`` equal to each
rank's own blocks.

The state specs are ``repro``'s ``opt_state_specs`` on its stacked tree,
less the stack entry. The one stated departure: where ``repro``'s ZeRO-1
puts "data" on the stack dimension (a stacked state whose only other
replicated dimension does not divide "data" or is smaller, as MLA's
``wo``'s ``vr``, (2, H v) over (None, "model")), the port, which holds
one tensor a layer, holds that state whole over "data".
"""
import time

import jax
import numpy as np
import pytest

import torch_tp_mixers_worker as W
from repro.models.model import Model as JModel
from repro.optim.adamw import OptConfig as JOptConfig
from repro.optim.adamw import init_opt_state as jinit_opt
from repro.sharding import rules as jrules
from repro.sharding.spec import Axes as JAxes
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.sharding.rules import _norm
from test_torch_tp_mixers import TIMEOUT_S, TOL, close, init_weights, jconfig, start_ranks
from test_torch_tp_mixers import train_batch, wait_ranks

# the state repro's ZeRO-1 puts "data" on the stack of: its only other
# dimension is over "model"
STACK_DATA = {"mla": "mix.wo.vr", "mamba": "mix.out_proj.vr"}


def _oracle(name: str, params, batch: dict) -> dict:
    """``repro``'s state after each of ``W.ADAFACTOR_STEPS``."""
    cfg = jconfig(name)
    tcfg = JTrainConfig(opt=JOptConfig(**W.AF_OPT), aux_coef=0.0)
    step = jax.jit(jmake_step(JModel(cfg), tcfg))
    ost = jinit_opt(params, tcfg.opt)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    tc = W.config(name)
    out = {}
    for i in W.ADAFACTOR_STEPS:
        params, ost, m = step(params, ost, jax.numpy.int32(i), jb)
        p, o = jax.tree.map(np.asarray, (params, ost))
        out[i] = {"metrics": {k: float(v) for k, v in m.items()},
                  "params": convert.params_from_jax(tc, p),
                  "v": convert.opt_state_from_jax(tc, o)["v"]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_adafactor")
    params, batches = {}, {}
    for seed, name in enumerate(W.AF_CONFIGS):
        params[name] = init_weights(d, f"af-{name}", seed + 31)
        batches[name] = train_batch(W.config(f"af-{name}"), seed + 41)
        np.savez(d / f"batch_af-{name}.npz", **batches[name])
    started = start_ranks(d, "adafactor")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        want = {name: _oracle(f"af-{name}", params[name], batches[name])
                for name in W.AF_CONFIGS}
    finally:
        ranks = wait_ranks(d, "adafactor", started, deadline)
    return want, ranks


@pytest.mark.parametrize("step", W.ADAFACTOR_STEPS)
@pytest.mark.parametrize("case", list(W.ADAFACTOR_CASES))
def test_adafactor_steps_match_repro(runs, case, step):
    want, ranks = runs
    w = want[W.ADAFACTOR_CASES[case][0]][step]
    top = max(float(np.abs(np.asarray(t, np.float32)).max()) for t in w["params"].values())
    for got in ranks:
        g = got[case][step]
        for k in ("loss", "grad_norm", "lr"):
            assert abs(g["metrics"][k] - w["metrics"][k]) <= TOL * abs(w["metrics"][k]), k
        close(g["params"], w["params"], "params", scale=top)
        for n, kinds in w["v"].items():
            close(g["v"][n], kinds, f"v/{n}")
        assert g["replicas_equal"]
        assert got[case]["reshard_equal"]  # convert.shard_state of the whole states


def _repro_specs(name: str, mesh_shape: tuple, e2d: bool) -> dict:
    """``repro``'s ZeRO-1 Adafactor state specs on its stacked tree,
    {port name: {kind: stacked spec}}."""
    cfg = jconfig(f"af-{name}")
    axes = JAxes(mesh_shape=dict(zip(("data", "model"), mesh_shape)),
                 expert=("data", "model") if e2d else ("model",))
    abstract = jax.eval_shape(lambda: JModel(cfg, axes).init(jax.random.key(0)))
    state = jax.eval_shape(lambda p: jinit_opt(p, JOptConfig(**W.AF_OPT)), abstract)
    specs = jrules.opt_state_specs(state, jrules.param_specs(abstract, cfg, axes), cfg, axes)
    out: dict = {}
    paths = jax.tree_util.tree_flatten_with_path(
        specs["v"], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in paths:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        out[tuple(keys)] = _norm(tuple(spec))
    return out


@pytest.mark.parametrize("case", list(W.ADAFACTOR_CASES))
def test_state_specs_are_repros_less_the_stack(runs, case):
    """Every state's spec is ``repro``'s stacked spec less its stack
    entry; the states whose stack entry is "data" in ``repro`` (held whole
    over "data" by the port) are named, and hold there the same values on
    every rank of "data" (the gathered states above), and the local
    shapes are the specs' blocks."""
    _, ranks = runs
    name, mname = W.ADAFACTOR_CASES[case]
    shape, e2d = W.MESHES[mname]
    want = _repro_specs(name, shape, e2d)
    got = ranks[0][case]["specs"]
    cfg = W.config(f"af-{name}")
    layer, departures, seen = 0, set(), 0
    for s, (period, count) in enumerate(cfg.segments):
        for c in range(count):
            for j in range(len(period)):
                prefix = f"layers.{layer}."
                for n, kinds in got.items():
                    if not n.startswith(prefix):
                        continue
                    leaf = n[len(prefix):].split(".")
                    for kind, spec in kinds.items():
                        stacked = want[("segments", s, j, *leaf, kind)]
                        assert spec == _norm(stacked[1:]), (n, kind, stacked)
                        if stacked[0] == "data":
                            departures.add(f"{n[len(prefix):]}.{kind}")
                        seen += 1
                layer += 1
    assert seen == sum(len(k) for n, k in got.items() if n.startswith("layers."))
    if shape[0] > 1:  # "data" of 2 divides the stack of 2 (of 1 it splits nothing)
        assert STACK_DATA[name] in departures, departures
