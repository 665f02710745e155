#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each:
  1. the card (nvidia-smi) and the build of the CUDA kernels from the
     sources in this checkout, with its time;
  2. each of the four bitonic kernels against its plain PyTorch twin on the
     card, at the main path's shapes and at edge shapes (rows of 1024 to
     8192, the key/value type combinations, stable on and off, duplicate
     keys and +-0.0), with exact equality; each kernel's median time beside
     its bound, the twin's time and one torch.sort call on the same rows;
  3. ``repro_torch.sort`` through its entry point (the main path), checked
     against torch.sort on the card: n = 2^22 float32 keys at the default
     limits, n = 2^22 int32 keys with 4 distinct values (imbalance below
     1.01), want="order", order="desc", a float32 payload, and n = 2^27
     float32 keys on p = 8 with stream_threshold=None. Every kernel's
     launch count is set to 0 before this phase and read after it; each of
     the four must have launched;
  4. one JSON line {"kernels": [...]} with each kernel's numbers, the card's
     name and power limit, and, last, {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line. Without a CUDA
device, or without the port beside this script, it exits 2 and prints no
result. It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM non-tensor float32 rate (NVIDIA data sheet)
SOURCE = "src/repro_torch/kernels/csrc/bitonic.cu"
REPLACES = {
    "bitonic_sort_rows": "src/repro/kernels/bitonic.py:123",
    "bitonic_sort_rows_kv": "src/repro/kernels/bitonic.py:128",
    "bitonic_merge_rows": "src/repro/kernels/bitonic.py:134",
    "bitonic_merge_rows_kv": "src/repro/kernels/bitonic.py:140",
}


def log(*parts) -> None:
    print(*parts, flush=True)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the pair (0.0 when equal bit for bit); raises
    unless the two agree bit for bit."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    wide = torch.float64 if a.dtype.is_floating_point else torch.int64
    err = float((a.to(wide) - b.to(wide)).abs().max()) if a.numel() else 0.0
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"kernel and twin differ (max abs err {err})")
    return err


def time_ms(fn, reps: int = 20) -> float:
    """Median time of ``fn`` on the card over ``reps`` runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def network_ops(rows: int, n: int, merge: bool) -> int:
    """Compare-exchanges of the network: one comparison per pair per stage."""
    k = n.bit_length() - 1
    stages = k if merge else k * (k + 1) // 2
    return rows * (n // 2) * stages


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 2


def rows_of(gen, rows, n, dtype, kind, device):
    import torch

    if kind == "dup":
        x = torch.randint(0, 5, (rows, n), generator=gen, device=device)
    else:
        x = torch.randint(-(1 << 20), 1 << 20, (rows, n), generator=gen, device=device)
    if dtype == torch.float32:
        x = x.to(torch.float32) / 7
        if kind == "dup":
            x = torch.where(torch.rand(x.shape, generator=gen, device=device) < 0.5, x, -x)
        return x  # duplicates include +0.0 and -0.0
    if dtype == torch.uint32:
        return (x.to(torch.int32) ^ (-(1 << 31))).view(torch.uint32)
    return x.to(dtype)


def check_kernels(device) -> dict:
    """Phase 2: every kernel equals its twin exactly; times at main-path
    shapes. Returns per-kernel numbers for the final JSON line."""
    import torch
    from repro_torch.kernels import bitonic

    gen = torch.Generator(device=device).manual_seed(0)
    i32, u32, f32 = torch.int32, torch.uint32, torch.float32
    errs = {name: 0.0 for name in REPLACES}

    def sorted_rows(rows, n, dtype, kind):
        x = rows_of(gen, rows, n, dtype, kind, device)
        return bitonic.sort_rows_twin(x)

    edge = [(4096, 1024), (64, 2048), (32, 4096), (16, 8192)]
    for rows, n in edge:
        for kd in (i32, u32, f32):
            for kind in ("uniform", "dup"):
                k = rows_of(gen, rows, n, kd, kind, device)
                e = max_abs_err(bitonic.bitonic_sort_rows(k), bitonic.sort_rows_twin(k))
                errs["bitonic_sort_rows"] = max(errs["bitonic_sort_rows"], e)
                for vd in (i32, u32, f32):
                    v = rows_of(gen, rows, n, vd, "uniform", device)
                    for stable in (True, False):
                        ok, ov = bitonic.bitonic_sort_rows_kv(k, v, stable=stable)
                        tk, tv = bitonic.sort_rows_twin(k, v, stable=stable)
                        e = max(max_abs_err(ok, tk), max_abs_err(ov, tv))
                        errs["bitonic_sort_rows_kv"] = max(errs["bitonic_sort_rows_kv"], e)
                if n <= 4096:
                    a, b = sorted_rows(rows, n, kd, kind), sorted_rows(rows, n, kd, kind)
                    e = max_abs_err(bitonic.bitonic_merge_rows(a, b),
                                    bitonic.merge_rows_twin(a, b))
                    errs["bitonic_merge_rows"] = max(errs["bitonic_merge_rows"], e)
                    for vd in (i32, f32):
                        av = rows_of(gen, rows, n, vd, "dup", device)
                        bv = rows_of(gen, rows, n, vd, "dup", device)
                        for stable in (True, False):
                            ok, ov = bitonic.bitonic_merge_rows_kv(a, av, b, bv, stable=stable)
                            tk, tv = bitonic.merge_rows_twin(a, b, av, bv, stable=stable)
                            e = max(max_abs_err(ok, tk), max_abs_err(ov, tv))
                            errs["bitonic_merge_rows_kv"] = max(errs["bitonic_merge_rows_kv"], e)
        log(f"phase 2: rows ({rows}, {n}): all four kernels equal their twins exactly")
    torch.cuda.synchronize()

    # Timing at the shapes one sort of n = 2^22 float32 keys (p = 8,
    # tile = 1024) gives each kernel: one sort launch on (4096, 1024), and
    # merges whose outputs are 2048, 4096 and 8192 wide.
    numbers = {}
    keys = rows_of(gen, 4096, 1024, f32, "uniform", device)
    vals = torch.arange(keys.numel(), dtype=i32, device=device).reshape(keys.shape)
    nbytes = keys.numel() * 4
    b_ms, b_by = bound(2 * nbytes, network_ops(4096, 1024, merge=False))
    numbers["bitonic_sort_rows"] = dict(
        ms=time_ms(lambda: bitonic.bitonic_sort_rows(keys)),
        plain_ms=time_ms(lambda: bitonic.sort_rows_twin(keys), reps=3),
        library_ms=time_ms(lambda: torch.sort(keys, dim=-1)),
        bound_ms=b_ms, bound_by=b_by, shapes="(4096, 1024)")
    b_ms, b_by = bound(4 * nbytes, network_ops(4096, 1024, merge=False))
    numbers["bitonic_sort_rows_kv"] = dict(
        ms=time_ms(lambda: bitonic.bitonic_sort_rows_kv(keys, vals)),
        plain_ms=time_ms(lambda: bitonic.sort_rows_twin(keys, vals), reps=3),
        library_ms=time_ms(lambda: torch.sort(keys, dim=-1, stable=True)),
        bound_ms=b_ms, bound_by=b_by, shapes="(4096, 1024)")
    for name, kv in (("bitonic_merge_rows", False), ("bitonic_merge_rows_kv", True)):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for rows, n in ((2048, 1024), (1024, 2048), (512, 4096)):
            a = sorted_rows(rows, n, f32, "uniform")
            b = sorted_rows(rows, n, f32, "uniform")
            av = torch.arange(a.numel(), dtype=i32, device=device).reshape(a.shape)
            bv = av + a.numel()
            both = torch.cat([a, b], dim=-1)
            if kv:
                kern = lambda: bitonic.bitonic_merge_rows_kv(a, av, b, bv)
                twin = lambda: bitonic.merge_rows_twin(a, b, av, bv)
                lib = lambda: torch.sort(both, dim=-1, stable=True)
            else:
                kern = lambda: bitonic.bitonic_merge_rows(a, b)
                twin = lambda: bitonic.merge_rows_twin(a, b)
                lib = lambda: torch.sort(both, dim=-1)
            moved = (4 if kv else 2) * both.numel() * 4
            b_ms, b_by = bound(moved, network_ops(rows, 2 * n, merge=True))
            t = dict(ms=time_ms(kern), plain_ms=time_ms(twin, reps=3),
                     library_ms=time_ms(lib), bound_ms=b_ms)
            log(f"phase 2: {name} ({rows}, {n}) -> {2 * n}: "
                + " ".join(f"{k}={v:.4f}" for k, v in t.items()))
            for k in tot:
                tot[k] += t[k]
        numbers[name] = dict(tot, bound_by=b_by, shapes="(2048|1024|512, 1024|2048|4096)")
    for name, num in numbers.items():
        num["max_abs_err"] = errs[name]
        log(f"phase 2: {name} {num['shapes']}: kernel {num['ms']:.4f} ms, bound "
            f"{num['bound_ms']:.4f} ms ({num['bound_by']}), twin {num['plain_ms']:.4f} ms, "
            f"torch.sort {num['library_ms']:.4f} ms, max abs err {num['max_abs_err']}")
    return numbers


# ------------------------------------------------------------------ phase 3


def canon_pairs(keys, vals):
    """(key, value) pairs in lexicographic order, for tie-aware checks."""
    import torch

    by_val = torch.sort(vals, stable=True).indices
    order = by_val[torch.sort(keys[by_val], stable=True).indices]
    return keys[order], vals[order]


def run_main_path(device) -> dict:
    """Phase 3: repro_torch.sort through its entry point; returns the
    launch count of every kernel over this phase."""
    import torch
    import repro_torch
    from repro_torch.kernels import bitonic

    gen = torch.Generator(device=device).manual_seed(1)
    n = 1 << 22

    def timed(label, *args, **kwargs):
        before = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = repro_torch.sort(*args, device=device, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches - before[fn.__name__] for fn in bitonic.KERNELS}
        log(f"phase 3: {label}: {wall * 1e3:.3f} ms wall, counts {out.counts.tolist()}, "
            f"imbalance {out.imbalance():.6f}, retries {out.meta.retries}, "
            f"launches {launches}")
        return out

    bitonic.reset_launches()

    x = torch.rand(n, generator=gen, device=device)
    ref = torch.sort(x).values
    for i in range(3):
        out = timed(f"n=2^22 float32 uniform, run {i + 1}", x)
    assert out.meta.backend == "sim" and out.meta.plan.n_procs == 8
    assert torch.equal(out.keys, ref), "float32 keys not sorted"

    dup = torch.randint(0, 4, (n,), generator=gen, device=device, dtype=torch.int32)
    out = timed("n=2^22 int32, 4 distinct values", dup)
    assert torch.equal(out.keys, torch.sort(dup).values), "int32 keys not sorted"
    assert out.imbalance() < 1.01, f"imbalance {out.imbalance()} on duplicate keys"

    out = timed('n=2^22 float32 want="order"', x, want="order")
    assert torch.equal(out.order(), torch.sort(x, stable=True).indices.to(torch.int32))
    assert torch.equal(out.keys, ref)

    out = timed('n=2^22 float32 order="desc"', x, order="desc")
    assert torch.equal(out.keys, ref.flip(0)), "descending keys wrong"

    vals = torch.rand(n, generator=gen, device=device)
    out = timed("n=2^22 float32 keys + float32 values", x, vals)
    assert torch.equal(out.keys, ref)
    got_k, got_v = canon_pairs(out.keys, out.values)
    want_k, want_v = canon_pairs(x, vals)
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v), "payload wrong"

    big = torch.rand(1 << 27, generator=gen, device=device)
    out = timed("n=2^27 float32, p=8, stream_threshold=None", big,
                limits=repro_torch.SortLimits(stream_threshold=None))
    assert torch.equal(out.keys, torch.sort(big).values), "2^27 keys not sorted"
    del big, out

    launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
    log(f"phase 3: launches over the main path: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "bitonic.cu").exists():
        print("chip_smoke: the repro_torch sources are not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    device = torch.device("cuda")
    card = card_line()
    log(f"phase 1: card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = build.build("bitonic")
    log(f"phase 1: built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("phase 1: ptxas:", line.strip())

    numbers = check_kernels(device)
    launches = run_main_path(device)

    kernels = [
        dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
             launches=launches[name], max_abs_err=num["max_abs_err"], ms=num["ms"],
             plain_ms=num["plain_ms"], bound_ms=num["bound_ms"], bound_by=num["bound_by"],
             library_ms=num["library_ms"])
        for name, num in numbers.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
