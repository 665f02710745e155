"""One rank of the port's side of tests/test_torch_sharded_train.py.

    python tests/torch_sharded_worker.py RANK WORLD STORE_FILE DIR

Joins a gloo group of WORLD (4) CPU processes through a file store. For
each case of ``CASES`` it builds a ``DeviceMesh("cpu", shape)``, the
rank's part of the smoke model (``Model(cfg, axes=...)``) with the weights
``DIR/init_<config>.pt`` holds (``repro``'s, as a ``state_dict``, cut to
the rank's blocks by ``convert.shard_state``) and takes one train step on
its block of ``DIR/batch.npz``: the gathered parameters, AdamW's m and v
and the metrics. Besides:

  * ``aux``: experts over ("data", "model") with the aux loss on, and the
    oracle of its objective on one process (the one-rank model whose MoE
    aux is the mean of the four blocks' ``_router`` aux);
  * ``draws``: a sharded model's blocks gathered, and the one-rank model
    from the same seed;
  * ``pieces``: the vocab-parallel cross-entropy and embedding, with their
    gradients, against the one-rank ones; a per-rank checkpoint restored,
    and the ValueError of restoring it on another mesh shape;
  * replicas: whether every rank's replicated leaves are the same bits.

Everything goes to ``DIR/rank<RANK>.pt``. It imports nothing of JAX.
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
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import batch_block
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import Embed, embed_tokens
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptConfig
from repro_torch.sharding import parallel as par
from repro_torch.sharding import rules, spec
from repro_torch.train import loss as loss_lib
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step, state_specs

MESHES = {"1x4": ((1, 4), ("data", "model"), False),
          "2x2": ((2, 2), ("data", "model"), True),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"), False)}
CONFIGS = {"qwen3": ("qwen3-4b", {}), "moe": ("deepseek-moe-16b", {}),
           "padded": ("qwen3-4b", {"n_heads": 6})}
CASES = {f"{c}/{m}": (c, m) for c in ("qwen3", "moe") for m in MESHES}
CASES["padded/1x4"] = ("padded", "1x4")
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
STEP = 1  # lr(0) == 0


def config(name: str):
    arch, kw = CONFIGS[name]
    return dataclasses.replace(smoke_config(arch), dtype="float32", remat=True,
                               moe_capacity_factor=8.0, **kw)


def mesh_axes(name: str):
    shape, names, e2d = MESHES[name]
    mesh = DeviceMesh("cpu", torch.arange(dist.get_world_size()).reshape(shape),
                      mesh_dim_names=names)
    return spec.from_mesh(mesh, expert_2d=e2d)


def batch_of(d: pathlib.Path) -> dict:
    with np.load(d / "batch.npz") as z:
        return {k: z[k] for k in z.files}


def step_result(model, tcfg, params, ost, metrics) -> dict:
    axes = model.axes
    out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    out["params"] = convert.gather_state(params, model.specs, axes)
    out.update(convert.gather_state(ost, state_specs(model, tcfg), axes))
    return out


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


def train_case(d: pathlib.Path, cname: str, mname: str, aux_coef: float = 0.0):
    axes = mesh_axes(mname)
    cfg = config(cname)
    tcfg = TrainConfig(opt=OptConfig(**OPT), aux_coef=aux_coef)
    model = Model(cfg, axes=axes, device="cpu", seed=0)
    init = torch.load(d / f"init_{cname}.pt")
    model.load_state_dict(convert.shard_state(init, model.specs, axes))
    params, ost = init_train_state(model, tcfg)
    _, _, metrics = make_train_step(model, tcfg)(params, ost, STEP, batch_block(batch_of(d), axes))
    out = step_result(model, tcfg, params, ost, metrics)
    out["replicas_equal"] = replicas_equal(model, params, axes)
    out["local_tokens"] = batch_block(batch_of(d), axes)["tokens"].shape
    return out


def blocked_aux(real, n_batch: int, n_seq: int):
    """``moe_forward`` on one process whose aux is the mean of the blocks'
    aux: the tokens cut into n_batch x n_seq blocks as the mesh cuts them."""

    def forward(x, moe, cfg, axes=None, *, use_pallas=True):
        out, _ = real(x, moe, cfg, use_pallas=use_pallas)
        B, S, d = x.shape
        b, s = B // n_batch, S // n_seq
        aux = [moe_lib._router(x[i * b:(i + 1) * b, j * s:(j + 1) * s].reshape(-1, d),
                               moe.router, cfg)[2]
               for i in range(n_batch) for j in range(n_seq)]
        return out, torch.stack(aux).mean()

    return forward


def aux_case(d: pathlib.Path) -> dict:
    out = {"sharded": train_case(d, "moe", "2x2", aux_coef=0.01)}
    cfg = config("moe")
    tcfg = TrainConfig(opt=OptConfig(**OPT), aux_coef=0.01)
    model = Model(cfg, device="cpu", seed=0)
    model.load_state_dict(torch.load(d / "init_moe.pt"))
    params, ost = init_train_state(model, tcfg)
    real = moe_lib.moe_forward
    moe_lib.moe_forward = blocked_aux(real, 2, 2)
    try:
        _, _, metrics = make_train_step(model, tcfg)(params, ost, STEP, batch_of(d))
    finally:
        moe_lib.moe_forward = real
    out["oracle"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "params": {k: v.detach() for k, v in params.items()}, **ost}
    return out


def draws_case() -> dict:
    out = {}
    for cname, mname in (("qwen3", "1x4"), ("moe", "2x2")):
        axes = mesh_axes(mname)
        cfg = config(cname)
        sharded = Model(cfg, axes=axes, device="cpu", seed=5)
        whole = dict(Model(cfg, device="cpu", seed=5).named_parameters())
        got = convert.gather_state(dict(sharded.named_parameters()), sharded.specs, axes)
        local = {n: tuple(p.shape) for n, p in sharded.named_parameters()}
        out[cname] = {"equal": all(torch.equal(got[n], whole[n]) for n in whole),
                      "local_elems": sum(int(np.prod(s)) for s in local.values()),
                      "whole_elems": sum(p.numel() for p in whole.values())}
    return out


def pieces_case(d: pathlib.Path) -> dict:
    axes = mesh_axes("2x2")
    cfg = config("qwen3")
    out = {}
    rng = np.random.default_rng(7)
    V, Vp = 500, 512
    logits = torch.from_numpy((rng.standard_normal((4, 6, Vp)) * 3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, (4, 6)).astype(np.int32))
    labels[0, :3] = -1
    labels[3, 2] = V - 1  # in the last block, beside the padded columns
    logits[1, 2, labels[1, 2]] = 40.0
    whole = logits.clone().requires_grad_(True)
    want, wm = loss_lib.cross_entropy(whole, labels, V)
    (wg,) = torch.autograd.grad(want, whole)
    block = par.shard_leaf(logits, ("data", None, "model"), axes).clone().requires_grad_(True)
    got, gm = loss_lib.cross_entropy(block, par.shard_leaf(labels, ("data", None), axes), V,
                                     axes=axes)
    (gg,) = torch.autograd.grad(got, block)
    total = par.group(axes, "data").all_sum(got.detach())
    out["ce"] = {"loss": (float(total), float(want)),
                 "metrics": {k: (float(gm[k]), float(wm[k])) for k in wm},
                 "grad_err": float((gg - par.shard_leaf(wg, ("data", None, "model"), axes))
                                   .abs().max()),
                 "grad_max": float(wg.abs().max())}
    emb = Embed(cfg, Vp, torch.Generator().manual_seed(3), "cpu")
    ids = torch.from_numpy(rng.integers(0, Vp, (2, 9)))
    whole_out = embed_tokens(ids, emb)
    (gwhole,) = torch.autograd.grad(whole_out.square().sum(), emb.table)
    local = Embed(cfg, Vp // 2, None, "meta")
    local.table = torch.nn.Parameter(par.shard_leaf(emb.table.detach(), ("model", None),
                                                    axes).clone())
    got_out = embed_tokens(ids, local, axes)
    (glocal,) = torch.autograd.grad(got_out.square().sum(), local.table)
    out["embed"] = {"equal": torch.equal(got_out, whole_out),
                    "grad_equal": torch.equal(glocal, par.shard_leaf(gwhole, ("model", None),
                                                                     axes))}
    # a per-rank checkpoint: restored bits, and another mesh shape refused
    model = Model(config("moe"), axes=axes, device="cpu", seed=1)
    tcfg = TrainConfig(opt=OptConfig(**OPT))
    params, ost = init_train_state(model, tcfg)
    rank = dist.get_rank()
    ck = CheckpointManager(str(d / "ckpt"), keep=2, host_id=rank, n_hosts=dist.get_world_size(),
                           mesh_shape=axes.mesh_shape)
    before = {n: p.detach().clone() for n, p in params.items()}
    ck.save_async(3, (params, ost))
    ck.wait()
    dist.barrier()
    with torch.no_grad():
        for p in params.values():
            p.add_(1.0)
    (rp, _), step = ck.restore_latest((params, ost))
    out["ckpt"] = {"step": step, "equal": all(torch.equal(before[n], rp[n]) for n in before)}
    other = CheckpointManager(str(d / "ckpt"), host_id=rank, n_hosts=dist.get_world_size(),
                              mesh_shape={"data": 1, "model": 4})
    try:
        other.restore_latest((params, ost))
        out["ckpt"]["other_mesh"] = None
    except ValueError as e:
        out["ckpt"]["other_mesh"] = str(e)
    return out


def main(rank: int, world: int, store: str, d: pathlib.Path) -> None:
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    results = {name: train_case(d, c, m) for name, (c, m) in CASES.items()}
    results["aux"] = aux_case(d)
    results["draws"] = draws_case()
    results["pieces"] = pieces_case(d)
    torch.save(results, d / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, out = sys.argv[1:5]
    main(int(r), int(w), store, pathlib.Path(out))
