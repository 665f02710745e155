"""One rank of the port's side of tests/test_torch_tp_mixers.py and
tests/test_torch_sharded_adafactor.py.

    python tests/torch_tp_mixers_worker.py MODE RANK WORLD STORE_FILE DIR

Joins a gloo group of WORLD (4) CPU processes through a file store. Each
case builds a ``DeviceMesh("cpu", shape)``, the rank's part of a smoke
model (``Model(cfg, axes=...)``) with the weights ``DIR/init_<config>.pt``
holds (``repro``'s, as a ``state_dict``, cut to the rank's blocks by
``convert.shard_state``), and:

  * MODE ``mixers``, ``TRAIN_CASES``: one AdamW step on the rank's block
    of ``DIR/batch_<config>.npz``: the metrics and the gathered
    parameters; ``SERVE_CASES``: prefill, ``extend_caches``, the greedy
    decode steps (as ``generate`` strings them) and ``generate`` of the
    prompts of ``DIR/serve_<prompt>.npz`` (tokens, and the frames or
    vision of a model with memory), the rank's rows of every logit, the
    caches gathered (``convert.caches_to_numpy``) after prefill, after the
    extension and after the last step, and the tokens;
  * MODE ``adafactor``, ``ADAFACTOR_CASES``: ``ADAFACTOR_STEPS`` Adafactor
    steps with ZeRO-1 (float32 states), the metrics, parameters and
    states gathered after each, the rank's local state shapes, and whether
    replicated leaves are the same bits on every replica.

Everything goes to ``DIR/<MODE><RANK>.pt``. It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import datetime
import pathlib
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import batch_block
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptConfig
from repro_torch.serve import engine
from repro_torch.sharding import parallel as par
from repro_torch.sharding import rules, spec
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step, state_specs

MESHES = {"1x4": ((1, 4), False), "2x2": ((2, 2), True)}
CONFIGS = {"mla": "deepseek-v3-671b", "rec": "recurrentgemma-9b", "mamba": "falcon-mamba-7b",
           "whisper": "whisper-base", "vlm": "llama-3.2-vision-11b"}
ACCUM, B, S_TRAIN = 2, 4, 32
MEMORY = 16  # whisper's frames and the VLM's vision tokens: 4 blocks of 4 under seq_shard
PROMPTS = {"s16": 16, "s48": 48}  # the smoke recurrentgemma's window is 32
N_NEW = 8
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
STEP = 1  # lr(0) == 0
TRAIN_CASES = {f"{c}/{m}": (c, m) for c in CONFIGS for m in MESHES}
# name -> (config, mesh, seq_shard, prompt)
SERVE_CASES = {f"{c}/{m}/seq{sq}/{p}": (c, m, sq, p) for c in CONFIGS for m in MESHES
               for sq in (0, 1) for p in PROMPTS if p == "s16" or c == "rec"}
# Adafactor: stacked segments of two layers (the stack dimension divides
# "data"), factored from 16 columns so that the smoke widths factor
AF_CONFIGS = {"mla": "deepseek-v3-671b", "mamba": "falcon-mamba-7b"}
AF_OPT = dict(OPT, name="adafactor", factored_min_dim=16)
ADAFACTOR_STEPS = (1, 2)
ADAFACTOR_CASES = {f"{c}/{m}": (c, m) for c in AF_CONFIGS for m in MESHES}


def config(name: str):
    """The float32 smoke config of ``name`` (capacity factor 8: nothing
    drops); ``af-<name>``: its Adafactor variant, every segment twice as
    deep."""
    af = name.startswith("af-")
    base = smoke_config(AF_CONFIGS[name[3:]] if af else CONFIGS[name])
    cfg = dataclasses.replace(base, dtype="float32", remat=True, moe_capacity_factor=8.0)
    if af:
        segs = tuple((period, 2 * count) for period, count in cfg.segments)
        cfg = dataclasses.replace(cfg, segments=segs, n_layers=sum(
            len(p) * c for p, c in segs))
    return cfg


def memory_key(cfg) -> str | None:
    return "frames" if cfg.encoder_segments else ("vision" if cfg.n_vision_tokens else None)


def make_meshes() -> dict:
    return {name: DeviceMesh("cpu", torch.arange(dist.get_world_size()).reshape(shape),
                             mesh_dim_names=("data", "model"))
            for name, (shape, _) in MESHES.items()}


def load_npz(path: pathlib.Path) -> dict:
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def model_of(d: pathlib.Path, cname: str, axes) -> Model:
    model = Model(config(cname), axes=axes, device="cpu", seed=0)
    init = torch.load(d / f"init_{cname}.pt")
    model.load_state_dict(convert.shard_state(init, model.specs, axes))
    return model


def replicas_equal(model, params, axes) -> bool:
    """Whether every leaf's block is the same bits on each rank that holds
    it: gathered over the mesh axes its spec does not use."""
    same = True
    for name in sorted(params):
        used = rules.spec_axes(model.specs[name])
        g = par.group(axes, tuple(a for a in axes.mesh.mesh_dim_names if a not in used))
        if g is not None:
            t = params[name].detach().contiguous()
            same &= all(torch.equal(t, other) for other in g.all_gather(t).unbind(0))
    return bool(same)


def train_case(d: pathlib.Path, meshes: dict, cname: str, mname: str) -> dict:
    axes = spec.from_mesh(meshes[mname], expert_2d=MESHES[mname][1])
    model = model_of(d, cname, axes)
    tcfg = TrainConfig(opt=OptConfig(**OPT), aux_coef=0.0)
    params, ost = init_train_state(model, tcfg)
    batch = batch_block({k: v.numpy() for k, v in load_npz(d / f"batch_{cname}.npz").items()},
                        axes)
    _, _, metrics = make_train_step(model, tcfg)(params, ost, STEP, batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": convert.gather_state(params, model.specs, axes),
            "m": convert.gather_state(ost["m"], state_specs(model, tcfg)["m"], axes),
            "replicas_equal": replicas_equal(model, params, axes)}


@torch.no_grad()
def serve_case(d: pathlib.Path, meshes: dict, case: str) -> dict:
    cname, mname, seq_shard, prompt = SERVE_CASES[case]
    axes = spec.from_mesh(meshes[mname], expert_2d=MESHES[mname][1])
    model = model_of(d, cname, axes)
    cfg = model.cfg
    batch = load_npz(d / f"serve_{prompt}.npz")
    mem = memory_key(cfg)
    batch = {k: v for k, v in batch.items() if k == "tokens" or k == mem}
    tokens = batch["tokens"]
    Bg, S = tokens.shape

    def gathered(caches):
        return convert.caches_to_numpy(cfg, caches, axes, Bg)

    prefill = engine.make_prefill(model)
    step = engine.make_serve_step(model)
    logits, caches = prefill(batch, seq_shard=bool(seq_shard))
    out = {"rows": par.batch_rows(torch.arange(Bg), axes).numpy(),
           "prefill": logits.numpy(), "caches_prefill": gathered(caches)}
    caches = engine.extend_caches(model, caches, S, S + N_NEW)
    out["caches_extended"] = gathered(caches)
    vocab = cfg.vocab
    tok = par.gather_batch(logits[..., :vocab].argmax(-1).to(torch.int32), axes, Bg)
    toks, steps = [tok], []
    for i in range(N_NEW - 1):
        logits, caches = step(caches, tok, S + i)
        steps.append(logits.numpy())
        tok = par.gather_batch(logits[..., :vocab].argmax(-1).to(torch.int32), axes, Bg)
        toks.append(tok)
    out["steps"] = np.stack(steps)
    out["caches_decoded"] = gathered(caches)
    out["tokens"] = torch.cat(toks, dim=1).numpy()
    out["generate"] = engine.generate(model, batch, N_NEW, seq_shard=bool(seq_shard)).numpy()
    out["local"] = [{f"{key}.{n}": tuple(t.shape) for key, c in layer.items()
                     for n, t in c.items() if isinstance(t, torch.Tensor)} for layer in caches]
    return out


def snapshot(tree):
    """Copies of a tree's tensors (a leaf whole on every rank is gathered
    as the live tensor, which the next step writes)."""
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    return tree.detach().clone()


def adafactor_case(d: pathlib.Path, meshes: dict, cname: str, mname: str) -> dict:
    axes = spec.from_mesh(meshes[mname], expert_2d=MESHES[mname][1])
    model = model_of(d, f"af-{cname}", axes)
    tcfg = TrainConfig(opt=OptConfig(**AF_OPT), aux_coef=0.0)
    params, ost = init_train_state(model, tcfg)
    batch = batch_block({k: v.numpy() for k, v in
                         load_npz(d / f"batch_af-{cname}.npz").items()}, axes)
    step = make_train_step(model, tcfg)
    sspecs = state_specs(model, tcfg)
    out = {"local": {n: {k: tuple(t.shape) for k, t in s.items()} for n, s in ost["v"].items()},
           "specs": sspecs["v"]}
    for i in ADAFACTOR_STEPS:
        _, _, metrics = step(params, ost, i, batch)
        out[i] = {"metrics": {k: float(v) for k, v in metrics.items()},
                  "params": snapshot(convert.gather_state(params, model.specs, axes)),
                  "v": snapshot(convert.gather_state(ost["v"], sspecs["v"], axes)),
                  "replicas_equal": replicas_equal(model, params, axes)}
    # the whole states carried back into this rank's blocks (as
    # ``convert.opt_state_from_jax`` output would be)
    again = convert.shard_state(out[ADAFACTOR_STEPS[-1]]["v"], sspecs["v"], axes)
    out["reshard_equal"] = all(torch.equal(again[n][k], t) for n, d in ost["v"].items()
                               for k, t in d.items())
    return out


def main(mode: str, rank: int, world: int, store: str, d: pathlib.Path) -> None:
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    meshes = make_meshes()
    if mode == "mixers":
        results = {f"train/{name}": train_case(d, meshes, c, m)
                   for name, (c, m) in TRAIN_CASES.items()}
        results.update({f"serve/{case}": serve_case(d, meshes, case) for case in SERVE_CASES})
    else:
        results = {name: adafactor_case(d, meshes, c, m)
                   for name, (c, m) in ADAFACTOR_CASES.items()}
    torch.save(results, d / f"{mode}{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, r, w, store, out = sys.argv[1:6]
    main(mode, int(r), int(w), store, pathlib.Path(out))
