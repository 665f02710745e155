"""One rank of the port's side of tests/test_torch_sharded_serve.py.

    python tests/torch_sharded_serve_worker.py RANK WORLD STORE_FILE DIR

Joins a gloo group of WORLD (4) CPU processes through a file store. For
each case of ``CASES`` it builds the rank's part of the smoke model
(``Model(cfg, axes=...)`` on a ``DeviceMesh("cpu", shape)``) with the
weights ``DIR/init_<config>.pt`` holds (``repro``'s, as a ``state_dict``,
cut to the rank's blocks by ``convert.shard_state`` in the train layout),
and serves the prompts of ``DIR/tokens.npz`` through ``serve.engine``:
prefill, ``extend_caches``, the greedy decode steps (as ``generate``
strings them) and ``generate`` itself. It keeps the rank's rows of every
logit, the caches gathered (``convert.caches_to_numpy``) after prefill,
after the extension and after the last step, the tokens, and whether the
experts' decode layout is ``convert.shard_state`` of the whole weights by
``rules.param_specs(mode="decode")``.

``moe_tp``: ``moe.moe_forward(..., tp_axis="model")`` (EP x TP) on a
(2, 2) mesh, on the rank's rows of the tokens of
``torch_mesh_cases.moe_inputs`` at S = 1 and the decode layout of its
experts, for ``torch_mesh_cases.MOE_TP_CASES``. ``batcher``: the ValueError of a
``ContinuousBatcher`` over a sharded model.

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

import torch_mesh_cases as C
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models import moe as moe_lib
from repro_torch.models.model import Model
from repro_torch.serve import engine
from repro_torch.serve.batching import ContinuousBatcher
from repro_torch.sharding import parallel as par
from repro_torch.sharding import rules, spec

MESHES = {"1x4": ((1, 4), ("data", "model"), False),
          "2x2": ((2, 2), ("data", "model"), True),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"), False)}
CONFIGS = {"qwen3": ("qwen3-4b", {}), "moe": ("deepseek-moe-16b", {}),
           "padded": ("qwen3-4b", {"n_heads": 6})}
N_NEW = 8
# name -> (config, mesh, decode_moe_ep, seq_shard, n_new)
CASES = {f"{c}/{m}/ep{ep}/seq{sq}": (c, m, ep, sq, N_NEW)
         for c in ("qwen3", "moe") for m in MESHES for ep in (0, 1) for sq in (0, 1)}
CASES.update({f"padded/1x4/ep0/seq{sq}": ("padded", "1x4", 0, sq, N_NEW) for sq in (0, 1)})
# 16 + 7 = 23 positions divide over no model axis: the seq_shard cache
# grows into one that every rank holds whole
CASES.update({"qwen3/1x4/ep0/seq1/n7": ("qwen3", "1x4", 0, 1, N_NEW - 1),
              "moe/2x2/ep1/seq1/n7": ("moe", "2x2", 1, 1, N_NEW - 1)})


def config(name: str, **kw):
    arch, extra = CONFIGS[name]
    return dataclasses.replace(smoke_config(arch), dtype="float32", moe_capacity_factor=8.0,
                               **extra, **kw)


def oracle_key(case: str) -> tuple:
    """(config, n_new): what ``repro``'s one-device engine runs for it."""
    c, _, _, _, n_new = CASES[case]
    return c, n_new


def make_meshes() -> dict:
    return {name: DeviceMesh("cpu", torch.arange(dist.get_world_size()).reshape(shape),
                             mesh_dim_names=names)
            for name, (shape, names, _) in MESHES.items()}


def replicas_equal(t: torch.Tensor, axes, B: int) -> bool:
    """Whether the ranks that hold the same rows of a batch of B (along
    "model", and along the batch axes that do not split B) hold the same
    bits of ``t``."""
    bax = par.batch_axes(B, axes) or ()
    names = tuple(a for a in axes.mesh.mesh_dim_names if a not in bax)
    g = par.group(axes, names)
    return g is None or all(torch.equal(t, o) for o in g.all_gather(t.contiguous()).unbind(0))


def serve_case(d: pathlib.Path, meshes: dict, case: str) -> dict:
    cname, mname, ep, seq_shard, n_new = CASES[case]
    axes = spec.from_mesh(meshes[mname], expert_2d=MESHES[mname][2])
    cfg = config(cname, decode_moe_ep=bool(ep))
    init = torch.load(d / f"init_{cname}.pt")
    model = Model(cfg, axes=axes, device="cpu", seed=0)
    model.load_state_dict(convert.shard_state(init, model.specs, axes))
    with np.load(d / "tokens.npz") as z:
        tokens = torch.from_numpy(z["tokens"])
    B, S = tokens.shape
    same = True

    def gathered(caches):
        return convert.caches_to_numpy(cfg, caches, axes, B)

    prefill = engine.make_prefill(model)
    step = engine.make_serve_step(model)
    logits, caches = prefill({"tokens": tokens}, seq_shard=bool(seq_shard))
    same &= replicas_equal(logits, axes, B)
    out = {"rows": par.batch_rows(torch.arange(B), axes).numpy(),
           "prefill": logits.numpy(), "caches_prefill": gathered(caches)}
    caches = engine.extend_caches(model, caches, S, S + n_new)
    out["caches_extended"] = gathered(caches)
    vocab = cfg.vocab
    tok = par.gather_batch(logits[..., :vocab].argmax(-1).to(torch.int32), axes, B)
    toks, steps = [tok], []
    for i in range(n_new - 1):
        logits, caches = step(caches, tok, S + i)
        same &= replicas_equal(logits, axes, B)
        steps.append(logits.numpy())
        tok = par.gather_batch(logits[..., :vocab].argmax(-1).to(torch.int32), axes, B)
        toks.append(tok)
    out["steps"] = np.stack(steps)
    out["caches_decoded"] = gathered(caches)
    out["tokens"] = torch.cat(toks, dim=1).numpy()
    out["layout"] = model.layout
    dspecs = rules.param_specs(model.global_shapes, cfg, axes, mode="decode")
    want = convert.shard_state(init, dspecs, axes)
    out["decode_layout"] = all(torch.equal(p.detach(), want[n])
                               for n, p in model.named_parameters())
    out["generate"] = engine.generate(model, {"tokens": tokens}, n_new,
                                      seq_shard=bool(seq_shard)).numpy()
    out["replicas_equal"] = bool(same)
    out["local_cache"] = tuple(caches[0]["mix"]["k"].shape)
    return out


def moe_tp(meshes: dict) -> dict:
    axes = spec.from_mesh(meshes["2x2"], expert_2d=True)
    weights, x = C.moe_inputs()
    x = torch.from_numpy(x[:, :1])
    w = {k: torch.from_numpy(v) for k, v in weights.items()}
    specs = {"wi": ("data", None, "model"), "wg": ("data", None, "model"),
             "wo": ("data", "model", None)}
    local = moe_lib.MoE(w["router"], *(par.shard_leaf(w[k], specs[k], axes).contiguous()
                                       for k in ("wi", "wg", "wo")))
    ep_axes = dataclasses.replace(axes, expert=("data",))
    xl = par.batch_rows(x, axes)
    out = {"rows": par.batch_rows(torch.arange(x.shape[0]), axes).numpy()}
    for name, cf in C.MOE_TP_CASES.items():
        cfg = dataclasses.replace(smoke_config("deepseek-moe-16b"), dtype="float32",
                                  moe_capacity_factor=cf)
        with moe_lib.recording_drops() as drops:
            o, aux = moe_lib.moe_forward(xl, local, cfg, ep_axes, tp_axis="model")
        plain, plain_aux = moe_lib.moe_forward(xl, local, cfg, ep_axes, tp_axis="model",
                                               use_pallas=False)
        out[name] = {"out": o.numpy(), "aux": float(aux), "drops": list(drops),
                     "same_plain": torch.equal(o, plain) and torch.equal(aux, plain_aux)}
    return out


def batcher(meshes: dict) -> str | None:
    model = Model(config("qwen3"), axes=spec.from_mesh(meshes["1x4"]), device="cpu", seed=0)
    try:
        ContinuousBatcher(model, 2, 32)
    except ValueError as e:
        return str(e)
    return None


def main(rank: int, world: int, store: str, d: pathlib.Path) -> None:
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    meshes = make_meshes()
    with torch.no_grad():
        results = {case: serve_case(d, meshes, case) for case in CASES}
        results["moe_tp"] = moe_tp(meshes)
        results["batcher"] = batcher(meshes)
    torch.save(results, d / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, out = sys.argv[1:5]
    main(int(r), int(w), store, pathlib.Path(out))
