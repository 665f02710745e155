"""Dry run: count every (arch x shape x mesh) cell on the production mesh
with no card and no process group, the port's ``repro/launch/dryrun.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k [--multi-pod] [--opt] [--out results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

``repro`` lowers and compiles each cell on 512 placeholder devices and
reads the roofline terms from the compiled program. The port has no
compiled program: ``count_cell`` builds rank 0's part of the sharded model
on the meta device (``Model(cfg, axes=from_mesh(CountingMesh(...)),
device="meta")``: the rank's blocks by ``rules.param_specs``, in the train
layout or, for a decode cell, the decode one, as ``repro`` lowers them),
and runs the cell's eager program once under ``hlo_stats.Counts``: one
train step (``make_train_step`` with the ZeRO-1 optimizer states
``state_shapes`` gives), one prefill, or one decode step over
``init_caches`` (``rules.cache_specs``, with ``seq_shard`` under
``--opt``). Meta tensors hold shapes only, so nothing is allocated or
computed, and the ``CountingMesh``'s collectives move nothing and record
their bytes (``sharding/spec.py``). Every count is rank 0's. A train step
of more than two micro-batches is counted at one and at two, and each
later micro-batch adds what the second added (``_by_trip_count``): the
micro-batches are one program, as ``repro``'s scan body is one.

Each cell's JSON, ``{out}/{arch}_{shape}_{tag}.json``, has ``repro``'s
keys, ``flops_per_device``, ``hlo_bytes_per_device``,
``collective_bytes_per_device``, ``collectives``, ``bytes_per_device_gb``,
``memory_detail``, ``devices``, ``arch``, ``shape``, ``kind`` and
``mesh``, and adds ``kernels`` (calls of each ``repro_torch`` kernel op)
and ``count_s`` (the count's seconds, in place of ``compile_s``).
``repro``'s ``raw_cost_flops_body_once`` (XLA's cost analysis, which counts
a loop body once) has no counterpart in an eager program and is left out.
``memory_detail`` splits the peak into ``args_gb`` (parameters, optimizer
states, caches and the batch, from their shapes) and ``temp_gb`` (the
peak of what the program makes, ``hlo_stats.Counts``).

``Cell`` (and ``run_counted``) is the machinery under ``count_cell`` for
one config on any device; ``chip_smoke.py`` phase 19 runs it on the card
and on meta and holds the two counts to each other.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import SHAPES, cells, get_config
from repro_torch.data.pipeline import batch_block
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import Model
from repro_torch.optim import adamw as opt_lib
from repro_torch.serve.engine import make_prefill, make_serve_step
from repro_torch.sharding.spec import CountingMesh, from_mesh
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step


def _expert_2d(cfg: ModelConfig, mesh) -> bool:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    group = sizes.get("data", 1) * sizes.get("model", 1)
    return cfg.n_experts > 0 and cfg.n_experts % group == 0 and cfg.n_experts >= group


def pick_accum(cfg: ModelConfig, global_batch: int, batch_div: int) -> int:
    """Largest accum <= cfg.grad_accum with microbatch divisible by the
    data-parallel extent (multi-pod doubles the batch axes product)."""
    a = min(cfg.grad_accum, max(1, global_batch // max(batch_div, 1)))
    while a > 1 and (global_batch % a or (global_batch // a) % batch_div):
        a -= 1
    return max(a, 1)


def input_specs(cfg: ModelConfig, shape: tuple, *, accum: int | None = None,
                batch_div: int = 1, device="meta", seed: int = 0) -> dict:
    """Every model input of a cell of ``shape`` = (seq, batch, kind), a
    value of ``SHAPES`` or any other, as tensors on ``device`` (meta:
    shapes only; elsewhere drawn from ``seed``)."""
    seq, batch, kind = shape
    dt = torch_dtype(cfg.dtype)
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)

    def tokens(*s):
        return torch.randint(0, cfg.vocab, s, generator=gen, dtype=torch.int32, device=dev)

    def floats(*s):
        return torch.randn(s, generator=gen, device=dev).to(dt)

    if kind == "train":
        accum = accum or pick_accum(cfg, batch, batch_div)
        b = batch // accum
        spec = {"tokens": tokens(accum, b, seq), "labels": tokens(accum, b, seq)}
        if cfg.encoder_segments:
            spec["frames"] = floats(accum, b, seq, cfg.d_model)
        if cfg.n_vision_tokens:
            spec["vision"] = floats(accum, b, cfg.n_vision_tokens, cfg.d_model)
        return spec
    if kind == "prefill":
        spec = {"tokens": tokens(batch, seq)}
        if cfg.encoder_segments:
            spec["frames"] = floats(batch, seq, cfg.d_model)
        if cfg.n_vision_tokens:
            spec["vision"] = floats(batch, cfg.n_vision_tokens, cfg.d_model)
        return spec
    # decode: one new token against a seq-long cache
    return {"tokens": tokens(batch, 1)}


OPT1_FLAGS = ("decode_moe_ep", "flash_attention", "seq_shard_cache")
# seq_parallel is not in the default opt set (``repro``'s §Perf iteration
# C7: it regresses dense and SSM trains under GSPMD); --opt-flags takes it.
OPT2_FLAGS = OPT1_FLAGS + ("hierarchical_a2a",)
# per-arch extras: deepseek-v3's MLA projections are pinned, so sequence
# parallelism is a win there and only there (``repro``'s C5)
OPT_ARCH_EXTRA = {"deepseek-v3-671b": ("seq_parallel",)}


def opt_config(cfg: ModelConfig, arch: str, opt_flags) -> tuple[ModelConfig, bool]:
    """``cfg`` with the ``--opt`` switches on, and whether the decode caches
    are sequence-sharded. A switch the config lacks is refused."""
    flags = tuple(opt_flags) + OPT_ARCH_EXTRA.get(arch, ())
    fields = {f.name for f in dataclasses.fields(cfg)}
    lacking = [f for f in flags if f != "seq_shard_cache" and f not in fields]
    if lacking:
        raise ValueError(f"--opt-flags {lacking}: no such switch of {type(cfg).__name__}")
    cfg = dataclasses.replace(cfg, **{f: True for f in flags if f != "seq_shard_cache"})
    return cfg, "seq_shard_cache" in flags


def train_config(cfg: ModelConfig) -> TrainConfig:
    """``repro``'s dry-run TrainConfig: the config's optimizer and state
    dtype, bfloat16 gradient sums with bfloat16 states."""
    return TrainConfig(
        opt=opt_lib.OptConfig(name=cfg.optimizer, state_dtype=cfg.opt_state_dtype),
        accum_dtype="bfloat16" if cfg.opt_state_dtype == "bfloat16" else "float32")


class Cell:
    """One cell's program, ``shape`` = (seq, batch, kind), built on
    ``device``: rank 0's part of the model over ``mesh`` (None: one
    device), its inputs, and its optimizer states (train) or caches
    (decode). ``detail`` holds the bytes of each of them, ``accum`` the
    micro-batches of a train step; ``count()`` runs the step once under
    ``hlo_stats.Counts``."""

    def __init__(self, cfg: ModelConfig, shape: tuple, *, mesh: CountingMesh | None = None,
                 device="meta", accum: int | None = None, seq_shard: bool = False,
                 tcfg: TrainConfig | None = None, seed: int = 0):
        seq, batch, self.kind = shape
        self.mesh, self.accum = mesh, accum
        axes = from_mesh(mesh, expert_2d=_expert_2d(cfg, mesh)) if mesh is not None else None
        model = Model(cfg, axes=axes, device=device, seed=seed)
        if self.kind == "decode":
            model.set_layout("decode")
        self.detail = {"params": hlo_stats.tensor_bytes(list(model.parameters()))}
        if self.kind == "train":
            batch_div = axes.batch_size if axes is not None else 1
            inputs = input_specs(cfg, shape, accum=accum, batch_div=batch_div,
                                 device=device, seed=seed)
            self.accum = inputs["tokens"].shape[0]
            inputs = batch_block(inputs, axes)
            tcfg = tcfg or train_config(cfg)
            params, state = init_train_state(model, tcfg)
            self.detail["opt_state"] = hlo_stats.tensor_bytes(state)
            step = make_train_step(model, tcfg)
            self._run = lambda micro: step(params, state, 1,
                                           {k: v[:micro] for k, v in inputs.items()})
        elif self.kind == "prefill":
            inputs = input_specs(cfg, shape, device=device, seed=seed)
            prefill = make_prefill(model)
            self._run = lambda _: prefill(inputs, seq_shard=seq_shard)
        else:
            memory_len = seq if cfg.encoder_segments else cfg.n_vision_tokens
            caches = model.init_caches(batch, seq, memory_len=memory_len, seq_shard=seq_shard)
            inputs = input_specs(cfg, shape, device=device, seed=seed)
            self.detail["caches"] = hlo_stats.tensor_bytes(caches)
            serve_step = make_serve_step(model)
            self._run = lambda _: serve_step(caches, inputs["tokens"], seq - 1)
        self.detail["batch"] = hlo_stats.tensor_bytes(inputs)

    def count(self) -> dict:
        """``Counts.result()`` of one step, with ``args_detail`` (the bytes
        of the parameters, optimizer states, caches and batch) and
        ``accum``; a train step of more than two micro-batches by
        ``_by_trip_count``."""
        runs = []
        for micro in ((1, 2) if self.kind == "train" and self.accum > 2 else (self.accum,)):
            with hlo_stats.Counts(self.mesh, args=sum(self.detail.values())) as counts:
                self._run(micro)
            runs.append(counts.result())
        result = runs[0] if len(runs) == 1 else _by_trip_count(*runs, self.accum)
        return dict(result, args_detail=dict(self.detail), accum=self.accum)


def run_counted(cfg: ModelConfig, shape: tuple, **kwargs) -> dict:
    """``Cell(cfg, shape, **kwargs).count()``: one cell's program built
    and counted."""
    return Cell(cfg, shape, **kwargs).count()


def _by_trip_count(one: dict, two: dict, accum: int) -> dict:
    """The counts of a step of ``accum`` micro-batches from those of steps
    of one and two: every micro-batch after the first is the same program,
    so each adds what the second added (``repro`` multiplies a loop body
    by its trip count). The peak is the two-micro-batch step's: a later
    micro-batch holds what the second held."""
    def grow(a, b):
        return b + (accum - 2) * (b - a)

    out = dict(two)
    for key in ("dot_flops", "traffic", "coll_bytes"):
        out[key] = grow(one[key], two[key])
    for key in ("colls", "kernels"):
        out[key] = {k: grow(one[key].get(k, 0), v) for k, v in two[key].items()}
    return out


def count_cell(arch: str, shape_name: str, mesh: CountingMesh, *, verbose: bool = True,
               cfg: ModelConfig | None = None, opt: bool = False,
               opt_flags: tuple = OPT2_FLAGS) -> dict:
    """Count one (arch x shape) cell on ``mesh`` (``repro``'s
    ``lower_cell``). ``opt=True`` turns on the beyond-baseline variants
    (``OPT2_FLAGS``): sequence-sharded decode caches, EP(data) x TP(model)
    decode MoE, flash attention, the hierarchical expert exchange."""
    cfg = cfg or get_config(arch)
    seq_shard = False
    if opt:
        cfg, seq_shard = opt_config(cfg, arch, opt_flags)
    t0 = time.time()
    counts = run_counted(cfg, SHAPES[shape_name], mesh=mesh, seq_shard=seq_shard)
    elapsed = time.time() - t0
    result = analyze(counts, mesh)
    result.update(arch=arch, shape=shape_name, kind=SHAPES[shape_name][2],
                  mesh="x".join(str(s) for s in mesh.shape), count_s=round(elapsed, 1))
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} on {result['mesh']}: counted in "
              f"{elapsed:.1f}s, {result['bytes_per_device_gb']} GB/device, "
              f"flops/dev={result['flops_per_device']:.3e}")
    return result


def analyze(counts: dict, mesh: CountingMesh) -> dict:
    """``repro``'s report of a cell from ``run_counted``'s counts."""
    gb = 2 ** 30
    return {
        "flops_per_device": counts["dot_flops"],
        "hlo_bytes_per_device": counts["traffic"],
        "collective_bytes_per_device": counts["coll_bytes"],
        "collectives": counts["colls"],
        "bytes_per_device_gb": round(counts["peak_bytes"] / gb, 3),
        "memory_detail": {"args_gb": round(counts["args_bytes"] / gb, 3),
                          "temp_gb": round(counts["temp_peak_bytes"] / gb, 3),
                          **{f"{k}_gb": round(v / gb, 3)
                             for k, v in counts["args_detail"].items()}},
        "kernels": counts["kernels"],
        "devices": mesh.size(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="enable the optimized variants (OPT2_FLAGS)")
    ap.add_argument("--opt-flags", default=",".join(OPT2_FLAGS),
                    help="comma list of optimization switches")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    mesh = CountingMesh(*production_mesh_shape(multi_pod=args.multi_pod))
    todo = cells() if args.all else [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in todo:
        tag = "multi" if args.multi_pod else "single"
        if args.opt:
            tag += "_opt"
        try:
            res = count_cell(arch, shape, mesh, opt=args.opt,
                             opt_flags=tuple(args.opt_flags.split(",")))
            with open(f"{args.out}/{arch}_{shape}_{tag}.json", "w") as f:
                json.dump(res, f, indent=1)
        except Exception as e:  # surface, keep going in --all mode
            failures.append((arch, shape, repr(e)[:200]))
            print(f"[dryrun] FAIL {arch} x {shape}: {e}", file=sys.stderr)
            if not args.all:
                raise
    if failures:
        print(f"[dryrun] {len(failures)} failures: {failures}", file=sys.stderr)
        sys.exit(1)
    print("[dryrun] all cells counted OK")


if __name__ == "__main__":
    main()
