#!/usr/bin/env python3
"""Time text-edited variants of the row-sort kernel in csrc/bitonic.cu.

    python3 tools/bitonic_variants.py [--log-n 10] [--rows 4096 131072]
                                      [--only base,memory-only,...] [--batch 10]

Each variant is bitonic.cu with the text edits of VARIANTS below, built
for one row length only (2^log-n, so each build takes seconds) into
build/variants/, all builds started together; ``--source NAME=PATH`` adds
another version of the file as it is (the parent's, say). Then, in turns (the list
forward, then backward, on one card), each variant's bitonic_sort_rows
(float32 keys) and bitonic_sort_rows_kv (float32 keys, int32 values,
stable) are launched straight through ctypes on (rows, 2^log-n) seeded
keys, timed by chip_smoke.py's ``time_ms`` (median over 20 samples of a
batch of 10 launches between two CUDA events; ``--batch 1``: one launch
between two events, which also times the host's launch). Variants marked
"timing only" leave part of the network out and do not sort; the others
must equal torch.sort. Last, for each variant, its ptxas report (the most
registers of a row-sort kernel, and any with a stack frame or spills) and
the SASS of its two timed kernels (cuobjdump -sass, beside nvcc):
instructions in all and the most frequent opcodes. One JSON line per variant. Needs one CUDA device.
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
}


def variant_source(edits, log_n: int, path: pathlib.Path = SOURCE) -> str:
    """``path`` with ``edits``, and built for rows of 2^log_n only where it
    dispatches on log N at compile time."""
    src = path.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit target not found once in {path.name}: {old!r}")
        src = src.replace(old, new)
    for old, new in (("constexpr int kLogMaxRow = 13;", f"constexpr int kLogMaxRow = {log_n};"),
                     ("typename V, int LOG_N = 1>", f"typename V, int LOG_N = {log_n}>")):
        src = src.replace(old, new)
    return src


def build(name: str, src: str) -> tuple[pathlib.Path, dict]:
    """The variant's library, and from its ptxas report the most registers
    of a row-sort kernel and the row-sort kernels with a stack frame or
    spills."""
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(so), str(cu)],
                          check=True, capture_output=True, text=True)
    entries = {n: e for n, e in ptxas_entries(proc.stdout + proc.stderr).items()
               if "sort_rows_kernel" in n}
    return so, {"most registers": max((e.get("registers", 0) for e in entries.values()),
                                      default=0),
                "with stack or spills": [n for n, e in entries.items()
                                         if e.get("stack") or e.get("spills")]}


def sass_counts(so: pathlib.Path, log_n: int) -> dict:
    """Instructions of the keys-only (float) and the stable kv (float/int)
    kernel in the library's SASS."""
    cuobjdump = pathlib.Path(kbuild.nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.exists():
        cuobjdump = shutil.which("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for label, tag in (("keys", f"sort_rows_kernelILi{log_n}ELb0ELb0Efj"),
                       ("kv stable", f"sort_rows_kernelILi{log_n}ELb1ELb1Efi")):
        body = text.split(tag, 1)[1].split("Function : ", 1)[0] if tag in text else ""
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
        count = collections.Counter(op.split(".")[0] for op in ops)
        out[label] = {"instructions": len(ops), "top": dict(count.most_common(10))}
    return out


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
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda nm: build(nm, variant_source(sources[nm][0], args.log_n, sources[nm][1])),
            names)))
    sos = {name: so for name, (so, _) in built.items()}
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(str(so))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bitonic_sort_rows.argtypes = [P, P, L, I, I, P]
        lib.bitonic_sort_rows_kv.argtypes = [P, P, P, P, L, I, I, I, I, P]
        lib.bitonic_sort_rows.restype = lib.bitonic_sort_rows_kv.restype = I
        libs[name] = lib
    n = 1 << args.log_n
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    inputs = {}
    for rows in args.rows:
        k = torch.rand((rows, n), generator=gen, device=dev)
        v = torch.arange(k.numel(), dtype=torch.int32, device=dev).reshape(k.shape)
        inputs[rows] = (k, v, torch.empty_like(k), torch.empty_like(v),
                        torch.sort(k, dim=-1, stable=True))

    def launch(lib, rows, kv):
        k, v, ok, ov, _ = inputs[rows]
        if kv:
            return lib.bitonic_sort_rows_kv(k.data_ptr(), v.data_ptr(), ok.data_ptr(),
                                            ov.data_ptr(), rows, n, 2, 0, 1, stream)
        return lib.bitonic_sort_rows(k.data_ptr(), ok.data_ptr(), rows, n, 2, stream)

    results = {name: collections.defaultdict(list) for name in names}
    for name in [*names, *reversed(names)]:
        for rows in args.rows:
            for kv in (False, True):
                if launch(libs[name], rows, kv) != 0:
                    raise RuntimeError(f"{name}: launch refused")
                torch.cuda.synchronize()
                k, v, ok, ov, ref = inputs[rows]
                if not VARIANTS[name][0] and not (
                        torch.equal(ok, ref.values)
                        and (not kv or torch.equal(ov, ref.indices.to(torch.int32)
                                                   + (torch.arange(rows, device=dev) * n)
                                                   .to(torch.int32)[:, None]))):
                    raise AssertionError(f"{name}: rows {rows} kv {kv} not sorted")
                label = f"{'sort_kv' if kv else 'sort'} ({rows}, {n})"
                results[name][label].append(
                    time_ms(lambda: launch(libs[name], rows, kv), batch=args.batch))
    for rows in args.rows:
        k = inputs[rows][0]
        lib_ms = time_ms(lambda: torch.sort(k, dim=-1), batch=args.batch)
        print(json.dumps({"torch.sort": f"({rows}, {n})", "batch": args.batch, "ms": lib_ms}),
              flush=True)
    card = card_line()
    for name in names:
        print(json.dumps({"variant": name, "timing_only": VARIANTS[name][0], "card": card,
                          "batch": args.batch,
                          "ms (forward, backward)": dict(results[name]),
                          "ptxas": built[name][1],
                          "sass": sass_counts(sos[name], args.log_n)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
