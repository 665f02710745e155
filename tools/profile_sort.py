#!/usr/bin/env python3
"""Where the time of one ``repro_torch.sort`` goes on the GPU.

    python3 tools/profile_sort.py [--n 4194304] [--want values|order]
                                  [--case float32|int64|float64|nan|packed|lsd|stream]
                                  [--order asc|desc]

Sorts n keys (made on the card from a seed) once to warm up: float32 keys
(with 5% NaN for "nan"), int64 keys in [-2^62, 2^62) or float64 keys
(normal, times 1e100) in x64 mode (``SortLimits(x64=True)``), or a
multi-key pair as ``chip_smoke.py`` phase 3 sorts it ("packed": int32
ids in [0, 1000) ascending and int32 times in [0, 2^20) descending, one
packed int32 sort; "lsd": float32 and full-range int32 keys, two LSD
passes, with a float32 payload), all in-core (stream_threshold=None);
or, for "stream", float32 keys copied to the host (n = 2^23 unless
--n is given) at the default limits, which stream them out of core in
chunks of 2^16. Then it prints: the wall time per sort
without the profiler (host clock, synchronised, median of 5) beside one
``torch.sort`` of the first key (CUDA events, median of 5); and, over
three sorts under
``torch.profiler``, the device time per sort summed over the device-side
events (kernels, copies, fills), the device's idle share of the wall time
under the profiler, and the kernels with the most device time. For
"stream" it also reads the profiler's trace (written to
``build/profile_sort_trace.json``) for the host-to-device copies: the
streams they ran on, and how much of their time overlapped a kernel
running on another stream (the double buffering of the stream's chunks).
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def device_profile(label: str, fn, reps: int, top: int, trace_path=None) -> None:
    """Run ``fn`` ``reps`` times under ``torch.profiler`` and print the wall
    time (host clock, synchronised) and the device time per run, the
    device's idle share, and the ``top`` kernels by device time; with
    ``trace_path``, export the trace there and print the copies' overlap."""
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
    if trace_path is not None:
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
        copy_overlap(trace_path, reps)


def _union(ivals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for t0, t1 in sorted(ivals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def copy_overlap(trace_path, reps: int) -> None:
    """From a profiler trace: the host-to-device copies' streams and time,
    and the part of that time during which a kernel ran on another
    stream."""
    import bisect

    events = json.loads(pathlib.Path(trace_path).read_text())["traceEvents"]
    kernels, copies = {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        stream = (e.get("args") or {}).get("stream")
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") == "kernel":
            kernels.setdefault(stream, []).append(span)
        elif e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            copies.append((stream, span, e["name"]))
    if not copies:
        print("  host-to-device copies: none in the trace")
        return
    sort_streams = set(kernels)
    busy_by = {s: _union(sp for k, v in kernels.items() if k != s for sp in v)
               for s in {c[0] for c in copies}}
    totals: dict = {}
    for stream, (t0, t1), name in copies:
        busy = busy_by[stream]
        i = max(0, bisect.bisect_right([b[0] for b in busy], t0) - 1)
        over = 0.0
        while i < len(busy) and busy[i][0] < t1:
            over += max(0.0, min(t1, busy[i][1]) - max(t0, busy[i][0]))
            i += 1
        where = "a kernel stream" if stream in sort_streams else "a stream of its own"
        d = totals.setdefault((name, where), [0, 0.0, 0.0, set()])
        d[0] += 1
        d[1] += t1 - t0
        d[2] += over
        d[3].add(stream)
    print(f"  kernels ran on streams {sorted(sort_streams, key=str)}")
    for (name, where), (count, us, over, streams) in sorted(totals.items()):
        print(f"  {name} on {where} ({len(streams)} streams over {reps} sorts): "
              f"{count / reps:.0f} copies and {us / 1e3 / reps:.3f} ms per sort, "
              f"{over / 1e3 / reps:.3f} ms of it ({over / max(us, 1e-9):.3f}) under a kernel "
              f"on another stream")


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=None)
    parser.add_argument("--want", default="values", choices=("values", "order"))
    parser.add_argument("--order", default="asc", choices=("asc", "desc"),
                        help="the order of a single-key case (float32, int64, float64, nan, "
                             "stream)")
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--case", default="float32",
                        choices=("float32", "int64", "float64", "nan", "packed", "lsd",
                                 "stream"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_sort: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch

    args.n = args.n or (1 << 23 if args.case == "stream" else 1 << 22)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(args.n, generator=gen, device="cuda")
    keys, values, kw = x, None, dict(want=args.want, order=args.order)
    if args.case == "nan":
        x[torch.rand(args.n, generator=gen, device="cuda") < 0.05] = float("nan")
    elif args.case == "int64":
        keys = torch.randint(-(1 << 62), 1 << 62, (args.n,), generator=gen, device="cuda")
    elif args.case == "float64":
        keys = torch.randn(args.n, dtype=torch.float64, generator=gen, device="cuda") * 1e100
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
    limits = repro_torch.SortLimits(stream_threshold=None, x64=args.case in ("int64", "float64"))
    if args.case == "stream":
        keys, limits = x.cpu(), repro_torch.SortLimits()

    def sort():
        out = repro_torch.sort(keys, values, limits=limits, **kw)
        out.keys, out.values  # a stream result runs its passes here
        return out

    out = sort()
    torch.cuda.synchronize()
    print(f"case {args.case}: backend={out.meta.backend} multikey={out.meta.multikey}")
    walls, libs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        sort()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.sort(first, stable=args.want == "order", descending=kw["order"] == "desc")
        end.record()
        end.synchronize()
        libs.append(start.elapsed_time(end))
    print(f"n={args.n} want={args.want} order={kw['order']}: wall "
          f"{statistics.median(walls):.3f} ms per sort "
          f"(runs {', '.join(f'{w:.3f}' for w in walls)}); one torch.sort "
          f"{statistics.median(libs):.3f} ms")
    device_profile("  under the profiler, per sort:", sort, 3, args.top,
                   ROOT / "build" / "profile_sort_trace.json" if args.case == "stream" else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
