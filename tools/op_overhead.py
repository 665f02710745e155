#!/usr/bin/env python3
"""What reaching the bitonic kernels through their ``torch.library`` ops
costs the host, timed in alternating pairs of two trees of the port on
one card.

    python3 tools/op_overhead.py --tree parent=DIR --tree change=. [--pairs 10]

Each ``--tree NAME=ROOT`` is a checkout of the repo (``ROOT/src`` holds
its ``repro_torch``; a parent is unpacked with ``git archive`` into a
directory that ``.gitignore`` lists). One worker process a tree imports
that tree's port, builds its bitonic kernels (the first tree's worker
compiles them; the libraries are content-addressed, so the others get a
copy of the same files) and builds two models, bf16, seed 0, flash off (a
decode step reaches no flash): deepseek-moe-16b at full width cut to 1
dense + 3 MoE layers, prefilled with 2 prompts of 512 seeded tokens, and
qwen3-4b at full width and depth, prefilled with phase 5's 2 prompts of
8192. The workers
then take turns, ABBA (parent, change, change, parent, ...), ``--pairs``
rounds each. A round measures, on the card:

- ``tiny_us``: 2000 calls of ``bitonic_merge_rows_kv`` on (1, 8) int32
  rows, the host clock around them and one ``torch.cuda.synchronize()``
  after, over the calls: each launch is far shorter than the host's work
  around it, so this is the host's cost of a call (the wrapper's checks,
  the dispatcher, the launch);
- ``main_us``: the same at phase 2's main-path shape, (2048, 1024) +
  (2048, 1024) float32 keys with int32 values;
- ``prefill_ms``: the median of 16 prefills of the MoE model's batch
  (``engine.make_prefill``, each between two synchronizes): each MoE
  layer's dispatch sorts and merges through the kv ops
  (``prefill_launches`` counts the launches of one round);
- ``decode_ms``: the median of 16 greedy decode steps
  (``engine.make_serve_step``) of the MoE model. On one rank a decode
  step gathers each token's experts (``moe.moe_forward_decode``) and calls
  no kernel (``decode_launches`` counts them: 0), so this is a control;
- ``dense_decode_ms``: the same for qwen3-4b (phase 5's host-bound step,
  the other control);
- ``stream_ms``: ``repro_torch.sort`` of 2^25 float32 keys from the host
  through the stream (``stream_launches`` kernel calls).

Prints the card's name and power limit, one JSON line a round, and last
one JSON line with each tree's medians, minima and maxima and each
metric's per-pair difference (second tree less first). Needs one CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
METRICS = ("tiny_us", "main_us", "prefill_ms", "decode_ms", "dense_decode_ms", "stream_ms")
CALLS = 2000
B, S, STEPS = 2, 512, 16
DENSE_S = 8192  # phase 5's prompts
STREAM_N = 1 << 25


def per_call_us(fn, calls: int) -> float:
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def worker(src: str) -> int:
    """Build, then answer each line on stdin with one round's JSON (on the
    process's own stdout; whatever the port prints goes to stderr)."""
    import dataclasses

    import torch

    reply, sys.stdout = sys.stdout, sys.stderr
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    import repro_torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import bitonic, build
    from repro_torch.models.model import Model
    from repro_torch.serve import engine

    t0 = time.perf_counter()
    build.build("bitonic")
    build_s = time.perf_counter() - t0
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ops = {}
    for name, rows, n in (("tiny_us", 1, 8), ("main_us", 2048, 1024)):
        keys = torch.rand((rows, 2 * n), generator=gen, device=dev)
        a, b = keys[:, :n].sort().values, keys[:, n:].sort().values
        va = torch.arange(n, dtype=torch.int32, device=dev).expand(rows, n).contiguous()
        if name == "tiny_us":
            a, b = a.to(torch.int32), b.to(torch.int32)
        ops[name] = (a, b, va)

    def served(cfg, S):
        """Closures over a model's prefill and its decode step (caches of S +
        STEPS + 2), warmed up: ``prefill(i)`` prefills the batch again,
        ``run(i)`` takes step i at position S + 1 + i."""
        model = Model(cfg, device=dev, seed=0)
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                                         dtype=torch.int32)}
        prefill = engine.make_prefill(model)
        logits, caches = prefill(batch)
        caches = engine.extend_caches(model, caches, S, S + STEPS + 2)
        step = engine.make_serve_step(model)
        tok = logits[..., :cfg.vocab].argmax(-1).to(torch.int32)
        state = {"caches": step(caches, tok, S)[1], "tok": tok}  # warm-up

        def run(i):
            logits, state["caches"] = step(state["caches"], state["tok"], S + 1 + i)
            state["tok"] = logits[..., :cfg.vocab].argmax(-1).to(torch.int32)
        return lambda i: prefill(batch), run

    def median_step_ms(run) -> float:
        ms = []
        for i in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    full = get_config("deepseek-moe-16b")
    (dense, _), (moe_period, _) = full.segments
    moe_prefill, moe_step = served(dataclasses.replace(full, segments=((dense, 1), (moe_period, 3)),
                                          n_layers=4, dtype="bfloat16", flash_attention=False),
                      S)
    _, dense_step = served(dataclasses.replace(get_config("qwen3-4b"), dtype="bfloat16",
                                            flash_attention=False), DENSE_S)
    keys = torch.rand(STREAM_N, generator=gen, device=dev).cpu()
    repro_torch.sort(keys, device=dev).keys  # warm-up
    print(json.dumps({"ready": True, "build_s": build_s}), file=reply, flush=True)

    for _ in sys.stdin:
        out = {}
        for name, (a, b, va) in ops.items():
            out[name] = per_call_us(lambda: bitonic.bitonic_merge_rows_kv(a, va, b, va), CALLS)
        bitonic.reset_launches()
        out["prefill_ms"] = median_step_ms(moe_prefill)
        out["prefill_launches"] = sum(fn.launches for fn in bitonic.KERNELS)
        bitonic.reset_launches()
        out["decode_ms"] = median_step_ms(moe_step)
        out["decode_launches"] = sum(fn.launches for fn in bitonic.KERNELS)
        out["dense_decode_ms"] = median_step_ms(dense_step)
        bitonic.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        repro_torch.sort(keys, device=dev).keys  # the stream's passes run here
        torch.cuda.synchronize()
        out["stream_ms"] = (time.perf_counter() - t0) * 1e3
        out["stream_launches"] = sum(fn.launches for fn in bitonic.KERNELS)
        print(json.dumps(out), file=reply, flush=True)
    return 0


def start(root: pathlib.Path) -> tuple:
    proc = subprocess.Popen([sys.executable, __file__, "--worker", str(root / "src")],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    ready = json.loads(proc.stdout.readline())
    return proc, ready


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=ROOT, a checkout of the repo; give two")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("op_overhead: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        return worker(args.worker)
    trees = [(name, pathlib.Path(root).resolve())
             for name, root in (t.split("=", 1) for t in args.tree)]
    if len(trees) != 2:
        ap.error("give two trees")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    procs = {}
    for name, root in trees:
        if procs:  # the first worker built the libraries: the same files serve the others
            (root / "build").mkdir(exist_ok=True)
            for lib in (trees[0][1] / "build").glob("lib*.so"):
                if not (root / "build" / lib.name).exists():
                    shutil.copy2(lib, root / "build" / lib.name)
        procs[name], ready = start(root)
        print(json.dumps({"tree": name, "root": str(root), **ready}), flush=True)
    got = {name: [] for name, _ in trees}
    first, second = (name for name, _ in trees)
    for i in range(args.pairs):
        for name in ((first, second) if i % 2 == 0 else (second, first)):
            proc = procs[name]
            proc.stdin.write("measure\n")
            proc.stdin.flush()
            row = json.loads(proc.stdout.readline())
            got[name].append(row)
            print(json.dumps({"pair": i, "tree": name, **row}), flush=True)
    for proc in procs.values():
        proc.stdin.close()
        proc.wait(timeout=120)
    summary = {}
    for m in METRICS:
        a, b = ([r[m] for r in got[first]], [r[m] for r in got[second]])
        diff = [y - x for x, y in zip(a, b)]
        summary[m] = {first: {"median": statistics.median(a), "min": min(a), "max": max(a)},
                      second: {"median": statistics.median(b), "min": min(b), "max": max(b)},
                      "diff_median": statistics.median(diff), "diff_min": min(diff),
                      "diff_max": max(diff)}
    summary["launches"] = {k: got[second][0][k]
                           for k in ("prefill_launches", "decode_launches", "stream_launches")}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
