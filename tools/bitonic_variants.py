#!/usr/bin/env python3
"""Time text-edited variants of the row-sort and merge kernels in csrc/bitonic.cu.

    python3 tools/bitonic_variants.py [--log-n 10] [--rows 4096 131072]
                                      [--only base,memory-only,...] [--batch 10]
                                      [--source NAME=PATH ...]

Each variant is bitonic.cu with the text edits of VARIANTS below, built
only for the row lengths timed (2^log-n for the row sorts, 2048 to 8192
for the merges, so each build takes about a minute) into build/variants/,
all builds started together; ``--source NAME=PATH`` adds another version
of the file as it is (the parent's, say). Then, in turns (the list
forward, then backward, on one card), each variant's bitonic_sort_rows
(float32 keys) and bitonic_sort_rows_kv (float32 keys, int32 values,
stable) on (rows, 2^log-n) seeded keys, and its bitonic_merge_rows and
bitonic_merge_rows_kv (the same types) on contiguous sorted operands at
the shapes a 2^22 sort gives them, (2048, 1024), (1024, 2048) and
(512, 4096), are launched straight through ctypes (a version whose merge
entry points take no row strides is called without them) and timed by
chip_smoke.py's ``time_ms`` (median over 20 samples of a batch of 10
launches between two CUDA events; ``--batch 1``: one launch between two
events, which also times the host's launch). Variants marked "timing
only" leave part of the network out and do not sort; the others must
equal torch.sort. Last, for each variant, its ptxas report (the most
registers of a row-sort and of a merge kernel, and any with a stack frame
or spills) and the SASS of its timed kernels at the first row length
(cuobjdump -sass, beside nvcc): instructions in all and the most frequent
opcodes. One JSON line per variant. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from chip_smoke import card_line, ptxas_entries, time_ms  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402

OUT = ROOT / "build" / "variants"
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "bitonic.cu"

# name -> (timing only?, [(old text, new text), ...])
VARIANTS = {
    "base": (False, []),
    "memory-only": (True, [("sort_phases<LOG_N, 0, HAS_V, TB>(k, v, sk, sv, t, flip);", "")]),
    "no-shared-stages": (True, [("if constexpr (S >= LE) {", "if constexpr (false) {")]),
    "no-register-stages": (True, [("reg_stages<cmin(S, LE - 1), 0, HAS_V, TB>(k, v, asc);", "")]),
    "no-flips": (True, [("k[r] = flip_if(k[r], want != flip);", "")]),
    "16-per-thread": (False, [("constexpr int kElems = 8;", "constexpr int kElems = 16;"),
                              ("constexpr int kLogElems = 3;", "constexpr int kLogElems = 4;")]),
    "min-threads-256": (False, [("constexpr int kMinThreads = 128;",
                                 "constexpr int kMinThreads = 256;")]),
    "merge-memory-only": (True, [(
        "sort_phase<LOG_N2, LOG_N2 - 1, HAS_V, TB>(k, v, sk, sv, t, flip);", "")]),
}
MERGE_SHAPES = ((2048, 1024), (1024, 2048), (512, 4096))  # (rows, n): outputs 2n wide


def variant_source(edits, log_lo: int, log_hi: int, path: pathlib.Path = SOURCE) -> str:
    """``path`` with ``edits``, and built for rows of 2^log_lo .. 2^log_hi
    only where it dispatches on log N at compile time."""
    src = path.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit target not found once in {path.name}: {old!r}")
        src = src.replace(old, new)
    for old, new in (("constexpr int kLogMaxRow = 13;", f"constexpr int kLogMaxRow = {log_hi};"),
                     ("typename V, int LOG_N = 1>", f"typename V, int LOG_N = {log_lo}>")):
        src = src.replace(old, new)
    return src


def build(name: str, src: str) -> tuple[pathlib.Path, dict]:
    """The variant's library, and from its ptxas report the most registers
    of a row-sort and of a merge kernel and those with a stack frame or
    spills."""
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(so), str(cu)],
                          check=True, capture_output=True, text=True)
    entries = ptxas_entries(proc.stdout + proc.stderr)
    out = {}
    for kernel in ("sort_rows_kernel", "merge_rows_kernel"):
        found = {n: e for n, e in entries.items() if kernel in n}
        out[kernel] = {"most registers": max((e.get("registers", 0) for e in found.values()),
                                             default=0),
                       "with stack or spills": [n for n, e in found.items()
                                                if e.get("stack") or e.get("spills")]}
    return so, out


def sass_counts(so: pathlib.Path, log_n: int, log_n2: int) -> dict:
    """Instructions of the keys-only (float) and the stable kv (float/int)
    row-sort kernel at 2^log_n and merge kernel at 2^log_n2 in the
    library's SASS (a version whose merge kernel is not templated on the
    row length: that one kernel)."""
    cuobjdump = pathlib.Path(kbuild.nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.exists():
        cuobjdump = shutil.which("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for label, tags in (("sort keys", [f"sort_rows_kernelILi{log_n}ELb0ELb0Efj"]),
                        ("sort kv stable", [f"sort_rows_kernelILi{log_n}ELb1ELb1Efi"]),
                        ("merge keys", [f"merge_rows_kernelILi{log_n2}ELb0ELb0Efj",
                                        "merge_rows_kernelIffLb0E"]),
                        ("merge kv stable", [f"merge_rows_kernelILi{log_n2}ELb1ELb1Efi",
                                             "merge_rows_kernelIfiLb1E"])):
        tag = next((t for t in tags if t in text), None)
        body = text.split(tag, 1)[1].split("Function : ", 1)[0] if tag else ""
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
        count = collections.Counter(op.split(".")[0] for op in ops)
        out[label] = {"instructions": len(ops), "top": dict(count.most_common(10))}
    return out


def declare(lib: ctypes.CDLL, strided: bool) -> None:
    """The C signatures of the four entry points; ``strided``: the merges
    take a row stride after each operand."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bitonic_sort_rows.argtypes = [P, P, L, I, I, P]
    lib.bitonic_sort_rows_kv.argtypes = [P, P, P, P, L, I, I, I, I, P]
    if strided:
        lib.bitonic_merge_rows.argtypes = [P, L, P, L, P, L, I, I, P]
        lib.bitonic_merge_rows_kv.argtypes = [P, L, P, L, P, L, P, L, P, P, L, I, I, I, I, P]
    else:
        lib.bitonic_merge_rows.argtypes = [P, P, P, L, I, I, P]
        lib.bitonic_merge_rows_kv.argtypes = [P, P, P, P, P, P, L, I, I, I, I, P]
    for fn in ("bitonic_sort_rows", "bitonic_sort_rows_kv", "bitonic_merge_rows",
               "bitonic_merge_rows_kv"):
        getattr(lib, fn).restype = I


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=10)
    ap.add_argument("--rows", type=int, nargs="+", default=[4096, 131072])
    ap.add_argument("--only", default=",".join(VARIANTS))
    ap.add_argument("--batch", type=int, default=10, help="launches between two CUDA events")
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                    help="also time another bitonic.cu as it is, e.g. the parent's "
                         "unpacked under build/")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bitonic_variants: no CUDA device", file=sys.stderr)
        return 2
    sources = {name: (VARIANTS[name][1], SOURCE) for name in args.only.split(",")}
    for spec in args.source:
        name, path = spec.split("=", 1)
        VARIANTS[name] = (False, [])
        sources[name] = ([], pathlib.Path(path).resolve())
    names = list(sources)
    log_n2s = [(2 * n).bit_length() - 1 for _, n in MERGE_SHAPES]
    log_lo, log_hi = min(args.log_n, *log_n2s), max(args.log_n, *log_n2s)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda nm: build(nm, variant_source(sources[nm][0], log_lo, log_hi,
                                                sources[nm][1])),
            names)))
    libs, strided = {}, {}
    for name, (so, _) in built.items():
        libs[name] = ctypes.CDLL(str(so))
        strided[name] = "long long a_stride" in sources[name][1].read_text()
        declare(libs[name], strided[name])
    n = 1 << args.log_n
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sorts = {}
    for rows in args.rows:
        k = torch.rand((rows, n), generator=gen, device=dev)
        v = torch.arange(k.numel(), dtype=torch.int32, device=dev).reshape(k.shape)
        sorts[rows] = (k, v, torch.empty_like(k), torch.empty_like(v),
                       torch.sort(k, dim=-1, stable=True))
    merges = {}
    for rows, m in MERGE_SHAPES:
        a = torch.rand((rows, m), generator=gen, device=dev).sort(dim=-1).values
        b = torch.rand((rows, m), generator=gen, device=dev).sort(dim=-1).values
        ids = torch.arange(2 * rows * m, dtype=torch.int32, device=dev).view(rows, 2 * m)
        av, bv = ids[:, :m].contiguous(), ids[:, m:].contiguous()
        both = torch.cat([a, b], dim=-1)
        ref = torch.sort(both, dim=-1, stable=True)
        merges[(rows, m)] = (a, b, av, bv, torch.empty_like(both), torch.empty_like(ids),
                             ref.values, torch.gather(ids, 1, ref.indices))

    def launch_sort(lib, rows, kv):
        k, v, ok, ov, _ = sorts[rows]
        if kv:
            return lib.bitonic_sort_rows_kv(k.data_ptr(), v.data_ptr(), ok.data_ptr(),
                                            ov.data_ptr(), rows, n, 2, 0, 1, stream)
        return lib.bitonic_sort_rows(k.data_ptr(), ok.data_ptr(), rows, n, 2, stream)

    def launch_merge(name, shape, kv):
        a, b, av, bv, ok, ov, _, _ = merges[shape]
        rows, m = shape
        lib, st = libs[name], strided[name]
        if kv:
            ops = [a, av, b, bv]
            ptrs = [x for t in ops for x in ((t.data_ptr(), m) if st else (t.data_ptr(),))]
            return lib.bitonic_merge_rows_kv(*ptrs, ok.data_ptr(), ov.data_ptr(), rows, m, 2, 0,
                                             1, stream)
        ptrs = [x for t in (a, b) for x in ((t.data_ptr(), m) if st else (t.data_ptr(),))]
        return lib.bitonic_merge_rows(*ptrs, ok.data_ptr(), rows, m, 2, stream)

    def sorted_right(name, label, kv, got_k, got_v, want_k, want_v):
        if not VARIANTS[name][0] and not (torch.equal(got_k, want_k)
                                          and (not kv or torch.equal(got_v, want_v))):
            raise AssertionError(f"{name}: {label} not sorted")

    results = {name: collections.defaultdict(list) for name in names}
    for name in [*names, *reversed(names)]:
        for rows in args.rows:
            for kv in (False, True):
                if launch_sort(libs[name], rows, kv) != 0:
                    raise RuntimeError(f"{name}: launch refused")
                torch.cuda.synchronize()
                k, v, ok, ov, ref = sorts[rows]
                label = f"{'sort_kv' if kv else 'sort'} ({rows}, {n})"
                ids = ref.indices.to(torch.int32) + (torch.arange(rows, device=dev) * n).to(
                    torch.int32)[:, None]
                sorted_right(name, label, kv, ok, ov, ref.values, ids)
                results[name][label].append(
                    time_ms(lambda: launch_sort(libs[name], rows, kv), batch=args.batch))
        for shape in MERGE_SHAPES:
            for kv in (False, True):
                if launch_merge(name, shape, kv) != 0:
                    raise RuntimeError(f"{name}: merge launch refused")
                torch.cuda.synchronize()
                _, _, _, _, ok, ov, want_k, want_v = merges[shape]
                label = f"{'merge_kv' if kv else 'merge'} {shape}"
                sorted_right(name, label, kv, ok, ov, want_k, want_v)
                results[name][label].append(
                    time_ms(lambda: launch_merge(name, shape, kv), batch=args.batch))
    for rows in args.rows:
        k = sorts[rows][0]
        lib_ms = time_ms(lambda: torch.sort(k, dim=-1), batch=args.batch)
        print(json.dumps({"torch.sort": f"({rows}, {n})", "batch": args.batch, "ms": lib_ms}),
              flush=True)
    card = card_line()
    for name in names:
        print(json.dumps({"variant": name, "timing_only": VARIANTS[name][0], "card": card,
                          "batch": args.batch,
                          "ms (forward, backward)": dict(results[name]),
                          "ptxas": built[name][1],
                          "sass": sass_counts(built[name][0], args.log_n, log_n2s[0])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
