#!/usr/bin/env python3
"""Where the backward of a MoE layer's dispatch spends its time on the GPU.

    python3 tools/profile_train.py [--tokens 8192]

``chip_smoke.py`` phase 11 finds the autograd node ``IndexBackward0`` (the
backward of an advanced-indexing gather, ``indexing_backward_kernel``) at
about a third of a training step's device time. This script splits it:

1. one MoE layer of phase 11's cut (deepseek-moe-16b at full width, bf16,
   capacity factor 1.25) on ``--tokens`` tokens, forward and backward of
   ``(out ** 2).mean() + 0.01 * aux`` under ``torch.profiler``: device
   time by autograd node;
2. the dispatch's two gathers that carry gradient, alone at the layer's
   shapes (``moe._dispatch_body``): the bucket gather ``xf[slot // K]``
   (each token K times; the C - A unused bucket slots clamped to the last
   token) and the expert gather ``pool[rows]`` (each pooled row once; the
   E * cap_e - A unused expert slots clamped to the last row). Each
   gather's backward is timed (CUDA events, median of 10) with the index
   as the dispatch builds it, with the unused slots spread over distinct
   rows instead (the same number of gathered rows, no run of thousands of
   equal indices), and through ``torch.index_select`` (whose backward is
   ``index_add_``) on the dispatch's index.

Prints the card's name and power limit. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def backward_ms(src, idx, gather, reps: int = 10) -> float:
    """Median time of the backward of ``gather(src, idx)`` (a fixed upstream
    gradient), CUDA events around ``torch.autograd.grad`` alone."""
    import torch

    out = gather(src, idx)
    up = torch.randn_like(out)
    times = []
    for _ in range(reps + 1):
        out = gather(src, idx)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, src, up)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=8192)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_line, moe_capacity, train_config
    from repro_torch.models import moe

    dev = torch.device("cuda")
    cfg = train_config()
    T, K, E, d = args.tokens, cfg.moe_topk, cfg.n_experts, cfg.d_model
    A = T * K
    C = moe_capacity(A, 1, cfg.moe_capacity_factor)
    cap_e = max(1, int(A // E * cfg.moe_capacity_factor) + 1)
    print(card_line(), flush=True)

    # 1. one MoE layer, forward and backward, by autograd node
    layer = moe.init_moe(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    x = torch.randn(1, T, d, device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev).manual_seed(1), requires_grad=True)

    def step():
        o, aux = moe.moe_forward(x, layer, cfg)
        return torch.autograd.grad((o.float() ** 2).mean() + 0.01 * aux, [x, *layer.parameters()])

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    node = "autograd::engine::evaluate_function: "

    def total_ms(e) -> float:  # renamed from cuda_time_total in newer torch
        v = getattr(e, "device_time_total", None)
        return (e.cuda_time_total if v is None else v) / 1e3

    def self_ms(e) -> float:
        v = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if v is None else v) / 1e3

    avg = prof.key_averages()
    dev_ms = sum(self_ms(e) for e in avg if str(e.device_type).endswith("CUDA"))
    nodes = sorted(((e.key[len(node):], total_ms(e)) for e in avg if e.key.startswith(node)),
                   key=lambda kv: -kv[1])
    print(f"one MoE layer, {T} tokens ({A} assignments, C {C}, {cap_e} an expert), forward "
          f"and backward: {dev_ms:.3f} ms device; backward nodes: " + "; ".join(
              f"{n} {ms:.3f} ms ({ms / dev_ms:.3f})" for n, ms in nodes[:6]), flush=True)
    del layer, x, prof

    # 2. the two gathers, alone
    gen = torch.Generator(device=dev).manual_seed(2)
    used_slot = torch.arange(C, device=dev) < A
    slot_tok = torch.randperm(A, device=dev, generator=gen) // K  # each token K times
    n_pool = C
    used_row = torch.zeros(E * cap_e, dtype=torch.bool, device=dev)
    used_row[torch.randperm(E * cap_e, device=dev, generator=gen)[:A]] = True
    rows = torch.full((E * cap_e,), n_pool - 1, device=dev)
    rows[used_row] = torch.randperm(n_pool, device=dev, generator=gen)[:A]  # each row once
    cases = {
        f"bucket gather xf[slot // K]: ({T}, {d}) -> ({C}, {d})": (
            T, torch.where(used_slot, torch.cat([slot_tok, slot_tok[:C - A]]), T - 1),
            torch.cat([slot_tok, torch.arange(C - A, device=dev) % T])),
        f"expert gather pool[rows]: ({n_pool}, {d}) -> ({E * cap_e}, {d})": (
            n_pool, rows, torch.where(used_row, rows,
                                      torch.arange(E * cap_e, device=dev) % n_pool)),
    }
    for label, (rows, clamped, spread) in cases.items():
        src = torch.randn(rows, d, device=dev, dtype=torch.bfloat16, requires_grad=True)
        copies = int((clamped == clamped.max()).sum())
        a = backward_ms(src, clamped, lambda s, i: s[i])
        b = backward_ms(src, spread, lambda s, i: s[i])
        c = backward_ms(src, clamped, lambda s, i: torch.index_select(s, 0, i))
        print(f"{label}: backward as dispatched ({copies} copies of one index) {a:.3f} ms; "
              f"unused slots spread over distinct rows {b:.3f} ms; index_select "
              f"(index_add_) {c:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
