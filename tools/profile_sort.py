#!/usr/bin/env python3
"""Where the time of one ``repro_torch.sort`` goes on the GPU.

    python3 tools/profile_sort.py [--n 4194304] [--want values|order]
                                  [--case float32|nan|packed|lsd]

Sorts n keys (made on the card from a seed) once to warm up: float32 keys
(with 5% NaN for "nan"), or a multi-key pair as ``chip_smoke.py`` phase 3 sorts it ("packed": int32
ids in [0, 1000) ascending and int32 times in [0, 2^20) descending, one
packed int32 sort; "lsd": float32 and full-range int32 keys, two LSD
passes, with a float32 payload). Then it prints: the wall time per sort
without the profiler (host clock, synchronised, median of 5) beside one
``torch.sort`` of the first key (CUDA events, median of 5); and, over
three sorts under
``torch.profiler``, the device time per sort summed over the device-side
events (kernels, copies, fills), the device's idle share of the wall time
under the profiler, and the kernels with the most device time. Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def device_profile(label: str, fn, reps: int, top: int) -> None:
    """Run ``fn`` ``reps`` times under ``torch.profiler`` and print the wall
    time (host clock, synchronised) and the device time per run, the
    device's idle share, and the ``top`` kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps

    def dev_us(e) -> float:  # renamed from self_cuda_time_total in newer torch
        v = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if v is None else v

    # device-side rows only: an aten:: row repeats the time of its kernels
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    device_ms = sum(dev_us(e) for e in events) / 1e3 / reps
    if device_ms == 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"{label} wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, "
          f"idle share {max(0.0, 1 - device_ms / wall_ms):.3f}")
    events.sort(key=dev_us, reverse=True)
    for e in events[:top]:
        ms = dev_us(e) / 1e3 / reps
        print(f"  {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  x{e.count // reps:<5d} {e.key[:90]}")


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=1 << 22)
    parser.add_argument("--want", default="values", choices=("values", "order"))
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--case", default="float32", choices=("float32", "nan", "packed", "lsd"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_sort: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(args.n, generator=gen, device="cuda")
    keys, values, kw = x, None, dict(want=args.want)
    if args.case == "nan":
        x[torch.rand(args.n, generator=gen, device="cuda") < 0.05] = float("nan")
    elif args.case == "packed":
        keys = (torch.randint(0, 1000, (args.n,), generator=gen, device="cuda", dtype=torch.int32),
                torch.randint(0, 1 << 20, (args.n,), generator=gen, device="cuda",
                              dtype=torch.int32))
        kw["order"] = ("asc", "desc")
    elif args.case == "lsd":
        keys = (x, torch.randint(-(1 << 31), (1 << 31) - 1, (args.n,), generator=gen,
                                 device="cuda", dtype=torch.int32))
        values = torch.rand(args.n, generator=gen, device="cuda") if args.want == "values" else None
        kw["order"] = ("asc", "desc")
    first = keys[0] if isinstance(keys, tuple) else keys
    limits = repro_torch.SortLimits(stream_threshold=None)
    out = repro_torch.sort(keys, values, limits=limits, **kw)
    torch.cuda.synchronize()
    print(f"case {args.case}: multikey={out.meta.multikey}")
    walls, libs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        repro_torch.sort(keys, values, limits=limits, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.sort(first, stable=args.want == "order")
        end.record()
        end.synchronize()
        libs.append(start.elapsed_time(end))
    print(f"n={args.n} want={args.want}: wall {statistics.median(walls):.3f} ms per sort "
          f"(runs {', '.join(f'{w:.3f}' for w in walls)}); one torch.sort "
          f"{statistics.median(libs):.3f} ms")
    device_profile("  under the profiler, per sort:",
                   lambda: repro_torch.sort(keys, values, limits=limits, **kw), 3, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
