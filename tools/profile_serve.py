#!/usr/bin/env python3
"""Where the time of qwen3-4b serving goes on the GPU.

    python3 tools/profile_serve.py [--batch 2] [--seq 8192] [--steps 8]

Builds qwen3-4b at full width (flash_attention=True, bf16, weights from a
seed) and prompts of seeded tokens on the card, warms up with one prefill
and one decode step, then profiles one prefill and ``--steps`` decode
steps, each under ``torch.profiler``: the wall time (host clock,
synchronised), the device time summed over the device-side events
(kernels, copies, fills), the device's idle share of the wall time, and
the kernels with the most device time. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seq", type=int, default=8192)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import engine
    from profile_sort import device_profile  # this script's neighbour in tools/

    cfg = dataclasses.replace(get_config("qwen3-4b"), flash_attention=True, dtype="bfloat16")
    model = Model(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    B, S = args.batch, args.seq
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")}
    prefill, step = engine.make_prefill(model), engine.make_serve_step(model)

    logits, caches = prefill(batch)  # warm-up: libraries, allocator
    caches = engine.extend_caches(model, caches, S, S + args.steps + 1)
    tok = logits[..., :cfg.vocab].argmax(-1)
    step(caches, tok, S)
    device_profile(f"prefill B={B} S={S}:", lambda: prefill(batch), 1, args.top)
    pos = iter(range(S + 1, S + 1 + args.steps))
    device_profile(f"decode step B={B} (cache {S + args.steps + 1}):",
                   lambda: step(caches, tok, next(pos)), args.steps, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
