#!/usr/bin/env python3
"""How far the recurrent models' decode drifts from their teacher-forced
forward, by depth and dtype, on one CUDA device.

    python3 tools/rec_decode_drift.py [--arch falcon-mamba-7b]
        [--runs bfloat16:16,bfloat16:32,bfloat16:64,float32:8] [--seeds 0,1]
        [--batch 2] [--prompt 4096] [--new 16]

For each run (dtype:layers, the published config cut in depth to that
many copies of its period, every width as published, seeded weights;
float32 with TF32 off) and each seed: a greedy prefill of ``--batch``
seeded prompts of ``--prompt`` tokens and ``--new`` - 1 decode steps,
then each step's logits against the teacher-forced forward of the prompt
and the tokens fed (``chip_smoke.decode_against_teacher``: the largest
|difference| as a fraction of the forward's largest |logit|). The path is
the same at every depth; what grows with depth in bfloat16 is the
rounding of the decode's and the prefill's GEMMs, which differ in shape.
One JSON line per run and seed, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from chip_smoke import card_line, decode_against_teacher  # noqa: E402


def cut(cfg, layers: int, dtype: str):
    """The config with ``layers`` layers: copies of its first period."""
    period = cfg.segments[0][0]
    if layers % len(period):
        raise SystemExit(f"{layers} layers is no whole number of periods of {len(period)}")
    return dataclasses.replace(cfg, dtype=dtype, n_layers=layers,
                               segments=((period, layers // len(period)),))


def main() -> int:
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--runs", default="bfloat16:16,bfloat16:32,bfloat16:64,float32:8")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--new", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rec_decode_drift: no CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    device = torch.device("cuda")
    print(card_line(), flush=True)
    for run in args.runs.split(","):
        dtype, layers = run.split(":")
        cfg = cut(get_config(args.arch), int(layers), dtype)
        torch.backends.cuda.matmul.allow_tf32 = dtype != "float32"
        for seed in map(int, args.seeds.split(",")):
            t0 = time.perf_counter()
            model = Model(cfg, device=device, seed=seed)
            gen = torch.Generator(device=device).manual_seed(23)
            batch = {"tokens": torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                                             generator=gen, device=device, dtype=torch.int32)}
            errs, n_tf = decode_against_teacher(model, batch, args.new)
            del model
            torch.cuda.empty_cache()
            print(json.dumps({"arch": args.arch, "dtype": dtype, "layers": int(layers),
                              "seed": seed, "teacher_forced_tokens": n_tf,
                              "errors": errs, "worst": max(errs),
                              "s": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
