"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro/launch/train.py``, with its flags and its lines: the
sort-bucketed data pipeline, the train step, checkpoints and restarts
through the fault-tolerance manager. One flag more, ``--device`` (default:
the card, by the device rule; ``--device cpu`` trains on the CPU). On one
rank it builds no mesh, as ``repro`` builds none on one device; with more
than one rank it raises NotImplementedError naming ROADMAP.md §1 item 11
(sharded parameters and optimizer states).

As in ``repro``, ``--layers n`` replaces the segments with n copies of the
config's first period: for deepseek-moe-16b, whose first segment is its
one dense layer, that is n dense layers and no MoE layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, PackedLoader
from repro_torch.device import resolve
from repro_torch.ft.manager import RestartManager
from repro_torch.models import not_ported
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptConfig
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


def main(argv=None):
    args = parse_args(argv)
    cfg = model_config(args)
    n_dev = world_size()
    if n_dev > 1:
        raise not_ported(f"training across {n_dev} ranks", "sharded_train")
    device = resolve(args.device)
    model = Model(cfg, device=device, seed=0)
    tcfg = TrainConfig(opt=OptConfig(
        name=cfg.optimizer, peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
        total_steps=args.steps, state_dtype=cfg.opt_state_dtype,
    ))

    params, opt_state = init_train_state(model, tcfg)
    n_params = sum(p.numel() for p in params.values())
    print(f"[train] {cfg.name}: {n_params:,} params on {n_dev} device(s)")

    step_fn = make_train_step(model, tcfg)
    loader = PackedLoader(data_config(cfg, args), cfg, device=device)
    it = iter(loader)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    start_step = 0
    if args.resume:
        restored, ck_step = ckpt.restore_latest((params, opt_state))
        if restored is not None:
            (params, opt_state), start_step = restored, ck_step
            print(f"[train] resumed from step {start_step}")

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
            print(f"[train] step {step}: loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({toks * (step - start_step + 1) / max(dt, 1e-9):.0f} tok/s)")

    (params, opt_state), final = mgr.run(
        (params, opt_state), start_step, args.steps,
        wrapped_step, lambda s: next(it), on_metrics,
    )
    ckpt.save_async(final, (params, opt_state))
    ckpt.wait()
    print(f"[train] done at step {final}; recoveries={mgr.recoveries} "
          f"stragglers={mgr.watchdog.stragglers}")


if __name__ == "__main__":
    main()
