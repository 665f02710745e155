"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro/launch/train.py``, with its flags and its lines: the
sort-bucketed data pipeline, the train step, checkpoints and restarts
through the fault-tolerance manager. Two flags more: ``--device`` (default:
the card, by the device rule; ``--device cpu`` trains on the CPU) and
``--dist-backend``. On one rank it builds no mesh, as ``repro`` builds
none on one device. With more than one rank (``torchrun``: RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) it joins the process
group on ``--dist-backend`` (``nccl``, the default, for one card a rank;
``gloo`` for ranks that share a card, which NCCL refuses), builds
``make_mesh_for(world)``, the rank's part of the model and of its
optimizer state (``Model(cfg, axes=...)``), loads its block of every
batch, saves its own blocks beside the mesh shape, and prints ``repro``'s
lines from rank 0. A rank uses the card ``LOCAL_RANK`` modulo the cards it
sees. Every config trains over a mesh, with AdamW or Adafactor.

On ``--resume`` the loader first makes, and drops, the batches of the
steps the checkpoint has taken, so a resumed run sees the batches an
uninterrupted one would.

As in ``repro``, ``--layers n`` replaces the segments with n copies of the
config's first period: for deepseek-moe-16b, whose first segment is its
one dense layer, that is n dense layers and no MoE layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, PackedLoader
from repro_torch.device import resolve
from repro_torch.ft.manager import RestartManager
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptConfig
from repro_torch.sharding.spec import from_mesh
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture")
    ap.add_argument("--width", type=int, default=0,
                    help="override d_model of the smoke config (scale up)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--dist-backend", default="nccl",
                    help="the process group's backend with more than one rank: nccl (one "
                         "card a rank) or gloo (ranks sharing a card, or the CPU)")
    return ap.parse_args(argv)


def model_config(args):
    """The config ``repro``'s launcher builds from the same flags."""
    cfg = get_config(args.arch) if args.full_config else smoke_config(args.arch)
    if args.width or args.layers:
        kw = {}
        if args.width:
            d = args.width
            kw.update(d_model=d, d_ff=4 * d, d_head=max(16, d // max(cfg.n_heads, 1)))
            if cfg.lru_width:
                kw["lru_width"] = d
        if args.layers:
            period = cfg.segments[0][0]
            kw["segments"] = ((period, args.layers),)
            kw["n_layers"] = args.layers * len(period)
        cfg = dataclasses.replace(cfg, **kw)
    return cfg


def data_config(cfg, args) -> DataConfig:
    return DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                      grad_accum=args.grad_accum, vocab=cfg.vocab,
                      bucket_docs=max(512, args.global_batch * 16))


def world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def join_group(backend: str, device: torch.device) -> int:
    """Join the torchrun process group (unless one is up); on the card,
    use the card LOCAL_RANK modulo the cards seen. Returns the rank."""
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_rank()


def main(argv=None):
    args = parse_args(argv)
    cfg = model_config(args)
    n_dev = world_size()
    device = resolve(args.device)
    rank, axes = 0, None
    if n_dev > 1:
        rank = join_group(args.dist_backend, device)
        axes = from_mesh(make_mesh_for(n_dev, device=device))
    say = print if rank == 0 else (lambda *a, **k: None)
    model = Model(cfg, axes=axes, device=device, seed=0)
    tcfg = TrainConfig(opt=OptConfig(
        name=cfg.optimizer, peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
        total_steps=args.steps, state_dtype=cfg.opt_state_dtype,
    ))

    params, opt_state = init_train_state(model, tcfg)
    shapes = model.global_shapes if model.sharded else {k: p.shape for k, p in params.items()}
    n_params = sum(math.prod(s) for s in shapes.values())
    say(f"[train] {cfg.name}: {n_params:,} params on {n_dev} device(s)")

    step_fn = make_train_step(model, tcfg)
    loader = PackedLoader(data_config(cfg, args), cfg, device=device, axes=axes)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3, host_id=rank, n_hosts=n_dev,
                             mesh_shape=axes.mesh_shape if axes else None)
    start_step = 0
    if args.resume:
        restored, ck_step = ckpt.restore_latest((params, opt_state))
        if restored is not None:
            (params, opt_state), start_step = restored, ck_step
            say(f"[train] resumed from step {start_step}")
            loader.fast_forward(start_step)
    it = iter(loader)

    mgr = RestartManager(ckpt, save_every=args.save_every)

    def wrapped_step(state, step, batch):
        p, o = state
        p, o, metrics = step_fn(p, o, step, batch)
        return (p, o), metrics

    t_start = time.time()

    def on_metrics(step, metrics):
        if "loss" in metrics and step % args.log_every == 0:
            toks = args.global_batch * args.seq_len * args.grad_accum
            dt = time.time() - t_start
            say(f"[train] step {step}: loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({toks * (step - start_step + 1) / max(dt, 1e-9):.0f} tok/s)")

    (params, opt_state), final = mgr.run(
        (params, opt_state), start_step, args.steps,
        wrapped_step, lambda s: next(it), on_metrics,
    )
    ckpt.save_async(final, (params, opt_state))
    ckpt.wait()
    say(f"[train] done at step {final}; recoveries={mgr.recoveries} "
        f"stragglers={mgr.watchdog.stragglers}")
    if axes is not None:
        import torch.distributed as dist

        dist.barrier()  # every rank's checkpoint is committed


if __name__ == "__main__":
    main()
