#!/usr/bin/env python3
"""Compare csrc/flash.cu with another version of it: SASS, registers, bits, times.

    python3 tools/flash_sass.py --against PATH [--out FILE]

Builds this checkout's ``csrc/flash.cu`` and the file at PATH (the parent
commit's, say) with the port's nvcc flags, both compilers started
together, into ``build/flash_sass/``. Then:

  * for each kernel both builds hold, matched by name and widths (a
    template on (DH) at dh is the pair (dh, dh) of one on (DQK, DV)): its
    registers, stack and spills from ptxas' report, its instructions in
    all from ``cuobjdump -sass``, and whether those instructions are the
    same one for one (opcode and operands; addresses and encodings left
    out), with the first that differs;
  * both libraries on every equal-width shape of ``chip_smoke.py``'s phase
    4 (``FLASH_SHAPES``), bf16 and float32, causal and full, on the same
    seeded inputs: whether the outputs are equal bit for bit;
  * both timed in turns (PATH's, this one's, this one's, PATH's) by
    ``chip_smoke.time_ms`` at qwen3-4b's prefill (2, 8192, 32, 8, 128),
    causal, in bf16 and float32.

One JSON object on the last line (and in FILE when given), with the card's
name and power limit. Exits 1 if any output differs. Needs one CUDA device
and nvcc.
"""
from __future__ import annotations

import argparse
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
from chip_smoke import FLASH_SHAPES, card_line, flash_inputs, ptxas_entries, time_ms  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402

OUT = ROOT / "build" / "flash_sass"
SOURCE = kbuild.CSRC / "flash.cu"
TIMED = (2, 8192, 32, 8, 128)


def kernel_key(mangled: str) -> tuple[str, tuple[int, int]] | None:
    """(name, (dqk, dv)) of a flash kernel's mangled name (in the source's
    anonymous namespace or not); None for any other function. A kernel with
    no width in its template is MLA's."""
    m = re.search(r"flash_fwd_[a-z0-9_]+?(?=[A-Z])", mangled)
    if m is None:
        return None
    name = m[0]
    widths = re.match(r"I((?:Li\d+E)+)E", mangled[m.end():])
    dims = tuple(int(d) for d in re.findall(r"Li(\d+)E", widths[1])) if widths else (192, 128)
    return name.removesuffix("_mla"), (dims[0], dims[-1])


def sass_by_kernel(text: str) -> dict:
    """``cuobjdump -sass`` output -> {kernel_key: [instruction, ...]}."""
    out = {}
    for part in text.split("Function : ")[1:]:
        key = kernel_key(part.split(None, 1)[0])
        if key is not None:
            out[key] = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*?)\s*;", part)
    return out


def build(tag: str, source: pathlib.Path) -> tuple[pathlib.Path, dict, dict]:
    """The library built from ``source``; its ptxas entries and its SASS,
    both by kernel_key."""
    cu, so = OUT / f"{tag}.cu", OUT / f"lib{tag}.so"
    shutil.copyfile(source, cu)
    proc = subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    ptxas = {kernel_key(n): e for n, e in ptxas_entries(proc.stdout + proc.stderr).items()}
    cuobjdump = pathlib.Path(kbuild.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump if cuobjdump.exists() else "cuobjdump"), "-sass",
                           str(so)], capture_output=True, text=True, check=True).stdout
    return so, ptxas, sass_by_kernel(text)


def runner(so: pathlib.Path, source: pathlib.Path):
    """fn(q, k, v, causal) -> out through the library's C entry point; a
    source whose entry point takes one width (no ``int dv``) is called so."""
    import torch

    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    two = "int dqk, int dv" in source.read_text()
    lib.flash_attention_fwd.argtypes = [P, P, P, P, I, I, I, I, I, *([I, I] if two else [I]),
                                        I, ctypes.c_float, I, P]
    lib.flash_attention_fwd.restype = I

    def run(q, k, v, causal):
        B, S, H, dh = q.shape
        T, KV = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        widths = (dh, dh) if two else (dh,)
        err = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      B, S, T, H, KV, *widths,
                                      0 if q.dtype == torch.bfloat16 else 1, dh ** -0.5,
                                      int(causal), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{so.name}: flash_attention_fwd returned {err}")
        return out

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=pathlib.Path, required=True,
                    help="another version of csrc/flash.cu")
    ap.add_argument("--out", type=pathlib.Path, help="also write the JSON object here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_sass.py needs a CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"against": args.against.resolve(), "this": SOURCE}
    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))

    kernels = []
    (_, p_old, s_old), (_, p_new, s_new) = built["against"], built["this"]
    for key in sorted(set(s_old) | set(s_new)):
        row = {"kernel": key[0], "widths": list(key[1]),
               "against": {**p_old.get(key, {}), "instructions": len(s_old.get(key, []))},
               "this": {**p_new.get(key, {}), "instructions": len(s_new.get(key, []))}}
        if key in s_old and key in s_new:
            a, b = s_old[key], s_new[key]
            row["same_sass"] = a == b
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
            if first is None and len(a) != len(b):
                first = min(len(a), len(b))
            if first is not None:
                row["first_difference"] = {"at": first, "against": a[first:first + 1],
                                           "this": b[first:first + 1]}
        kernels.append(row)
        print(json.dumps(row), flush=True)

    run = {tag: runner(so, sources[tag]) for tag, (so, _, _) in built.items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    bits, differ = [], 0
    for shape in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q, k, v = flash_inputs(gen, *shape, dtype, "cuda")
                same = torch.equal(run["against"](q, k, v, causal), run["this"](q, k, v, causal))
                differ += not same
                bits.append({"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
                             "causal": causal, "equal": same})
                print(json.dumps(bits[-1]), flush=True)

    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(gen, *TIMED, dtype, "cuda")
        name = str(dtype).removeprefix("torch.")
        times[name] = {"against": [], "this": []}
        for tag in ("against", "this", "this", "against"):
            times[name][tag].append(time_ms(lambda: run[tag](q, k, v, True), reps=10,
                                            batch=5 if dtype == torch.bfloat16 else 1))
        del q, k, v
    result = {"card": card_line(), "against": str(args.against), "kernels": kernels,
              "same_sass": sum(bool(r.get("same_sass")) for r in kernels),
              "compared": sum("same_sass" in r for r in kernels), "bits": bits,
              "outputs_differ": differ, "timed_shape": list(TIMED), "ms": times}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
