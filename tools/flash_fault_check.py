#!/usr/bin/env python3
"""Do the bf16 flash kernel's accuracy checks catch a broken kernel?

    python3 tools/flash_fault_check.py [--shape 2,8192,32,8,128]

Builds ``csrc/flash.cu`` as it is and with each planted fault of FAULTS (a
text replacement in a copy of the source under ``build/fault_check/``; the
source itself is never touched), runs every build on the same seeded bf16
inputs, causal and full, and prints for each the two checks that
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` apply:

  * max abs error against ``flash_attention_twin`` (p kept in f32, as the
    Pallas kernel keeps it), limit 2e-2;
  * ``flash.bf16_error`` against ``kernel_twin`` (the twin at the kernel's
    own rounding points): limit use <= 1 and mean |err| / rms <= 1e-3;
    ``floor_needed`` is the row-scale floor the element check would need.

One JSON line per (build, mask). Exits 0 when the unbroken build passes
both checks and every fault fails the second. Needs one CUDA device and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]

# name -> [(text in flash.cu, its replacement)], each text found exactly once.
# They break the wgmma kernel, which every bf16 shape of dh 64 or 128 takes
# (the default shape's route); its key tiles are 128 wide (kWgBk).
FAULTS = {
    "none": [],
    # one 128-key tile of a long row dropped: keys 6400..6527 never count
    "key tile 50 skipped": [
        ("if (edge_tile) {", "if (edge_tile || kt == 50) {"),
        ("if (key >= T || (causal && key > qpos)) x = kNegInf;",
         "if (key >= T || (causal && key > qpos) || kt == 50) x = kNegInf;"),
    ],
    # one key of a long row dropped (key 6400): a fault whose largest error
    # is about one p of 8192 times |v|
    "key 6400 skipped": [
        ("if (edge_tile) {", "if (edge_tile || kt == 50) {"),
        ("if (key >= T || (causal && key > qpos)) x = kNegInf;",
         "if (key >= T || (causal && key > qpos) || key == 6400) x = kNegInf;"),
    ],
    # the online softmax's correction left out: acc and l keep their scale
    # when the running max grows
    "rescale left out": [
        ("const float corr0 = exp2f(m0 - new0), corr1 = exp2f(m1 - new1);",
         "const float corr0 = 1.f, corr1 = 1.f;"),
    ],
}


def build_variant(name: str, edits) -> pathlib.Path:
    from repro_torch.kernels import build

    text = (build.CSRC / "flash.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} occurs {text.count(old)} times in flash.cu")
        text = text.replace(old, new)
    out_dir = build.BUILD_DIR / "fault_check"
    out_dir.mkdir(parents=True, exist_ok=True)
    slug = name.replace(" ", "_")
    src, lib = out_dir / f"flash_{slug}.cu", out_dir / f"libflash_{slug}.so"
    src.write_text(text)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return lib


def launch(lib, q, k, v, causal: bool):
    """What ``flash.flash_attention`` does on the card, with another build."""
    import torch

    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  B, S, T, H, KV, dh, dh, 0, dh ** -0.5, int(causal),
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: {lib.flash_error_string(err).decode()}")
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--shape", default="2,8192,32,8,128", help="B,S,H,KV,dh")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_fault_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash

    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, KV, dh = (int(x) for x in args.shape.split(","))
    with ThreadPoolExecutor(len(FAULTS)) as pool:
        libs = dict(zip(FAULTS, pool.map(build_variant, FAULTS, FAULTS.values())))
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((B, S, h, dh), generator=gen, device="cuda").to(torch.bfloat16)
               for h in (H, KV, KV))
    ok = True
    for causal in (True, False):
        pallas_twin = flash.flash_attention_twin(q, k, v, causal=causal)
        twin = flash.kernel_twin(q, k, v, causal=causal)
        for name, path in libs.items():
            got = launch(flash.declare(ctypes.CDLL(str(path))), q, k, v, causal)
            torch.cuda.synchronize()
            old = float((got.float() - pallas_twin.float()).abs().max())
            new = flash.bf16_error(got, twin)
            line = dict(fault=name, shape=[B, S, H, KV, dh], causal=causal,
                        max_abs_vs_pallas_twin=old, passes_2e_2=old <= 2e-2,
                        max_abs_vs_kernel_twin=new["max_abs"], limit_use=new["limit_use"],
                        floor_needed=new["floor_needed"], mean_rel=new["mean_rel"],
                        passes_bf16_error=new["ok"])
            print(json.dumps(line), flush=True)
            ok &= (old <= 2e-2 and new["ok"]) if name == "none" else not new["ok"]
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
