#!/usr/bin/env python3
"""Run the row-sort kernel of csrc/bitonic.cu on the CPU, one thread per
CUDA thread, and hold it to a serial run of the network.

    python3 tools/bitonic_cpu_check.py [--max-log-n 13]

The CUDA source is translated for g++ (C++20, pthreads): each CTA runs as
one std::thread per CUDA thread, ``__syncthreads()`` is a barrier over
them, ``__syncwarp()`` a barrier over the warp, and a launch a loop over
the CTAs. ``bitonic_sort_rows`` and ``bitonic_sort_rows_kv`` then sort
every row length 2 .. 2^max-log-n, 1, 3 and a number of rows that
leaves the last CTA short, with five key/value type pairs, stable on and
off, on keys with heavy duplicates, +-0.0, +-inf and NaN; each output
must equal, bit for bit, the network of
repro/kernels/bitonic.py::_sort_network run serially on the same row.
It also checks that a bad row length and an unaligned pointer are refused.

This checks the kernel's logic (layout, directions, barriers) without a
card: not its speed, nor what only nvcc would refuse. Builds in
build/cpu_check/; about half a minute in all at --max-log-n 13. Needs g++.
"""
from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "bitonic.cu"
OUT = ROOT / "build" / "cpu_check"

PRELUDE = r"""
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <memory>
#include <random>
#include <thread>
#include <type_traits>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
struct dim3 { unsigned x = 0, y = 0, z = 0; };
thread_local dim3 threadIdx;
static dim3 blockIdx, blockDim;
static std::barrier<>* g_cta;
static std::vector<std::unique_ptr<std::barrier<>>> g_warps;
inline void __syncthreads() { g_cta->arrive_and_wait(); }
inline void __syncwarp() { g_warps[threadIdx.x / 32]->arrive_and_wait(); }
inline unsigned __float_as_uint(float x) { unsigned u; std::memcpy(&u, &x, 4); return u; }
inline float __uint_as_float(unsigned u) { float x; std::memcpy(&x, &u, 4); return x; }
alignas(16) static unsigned char g_smem[1 << 17];
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
template <class F, class... A>
void emul_launch(F kern, unsigned grid, int threads, size_t smem, cudaStream_t, A... args) {
  if (smem > sizeof(g_smem) || threads % 32) std::abort();
  blockDim.x = threads;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::barrier<> cta(threads);
    g_cta = &cta;
    g_warps.clear();
    for (int w = 0; w < threads / 32; ++w) g_warps.emplace_back(new std::barrier<>(32));
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) ts.emplace_back([=] { threadIdx.x = t; kern(args...); });
    for (auto& t : ts) t.join();
  }
}
"""

HARNESS = r"""
template <class K, class V>
void network(K* k, V* v, int n, bool has_v, bool tb) {
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  for (int s = 0; s < log_n; ++s)
    for (int sub = s; sub >= 0; --sub)
      for (int q = 0; q < n / 2; ++q) {
        const int lo = ((q >> sub) << (sub + 1)) | (q & ((1 << sub) - 1)), hi = lo + (1 << sub);
        bool gt = k[lo] > k[hi], lt = k[lo] < k[hi];
        if (has_v && tb) {
          const bool eq = k[lo] == k[hi];
          gt = gt || (eq && v[lo] > v[hi]);
          lt = lt || (eq && v[lo] < v[hi]);
        }
        if ((lo & (2 << s)) == 0 ? gt : lt) {
          std::swap(k[lo], k[hi]);
          if (has_v) std::swap(v[lo], v[hi]);
        }
      }
}

static std::mt19937 rng(1);
template <class T> T special() {
  const int x = int(rng() % 7) - 3;
  if constexpr (std::is_same_v<T, float>) {
    if (x == 0) return (rng() & 1) ? 0.0f : -0.0f;
    if (x == 3) return INFINITY;
    if (x == -3) return -INFINITY;
    if (x == 2 && (rng() & 1)) return NAN;
    return float(x);
  } else {
    if (x == 3) return std::numeric_limits<T>::max();
    if (x == -3) return std::numeric_limits<T>::min();
    return T(x);
  }
}
template <class T> int code() {
  return std::is_same_v<T, int32_t> ? 0 : std::is_same_v<T, uint32_t> ? 1 : 2;
}

// mode 0: keys only; 1: kv, stable=False; 2: kv, stable=True
template <class K, class V> int check(long long rows, int n, int mode) {
  const size_t total = rows * n;
  std::vector<K> k(total), ko(total);
  std::vector<V> v(total), vo(total);
  for (auto& x : k) x = special<K>();
  for (auto& x : v) x = special<V>();
  std::vector<K> kw = k;
  std::vector<V> vw = v;
  for (long long r = 0; r < rows; ++r) network(&kw[r * n], &vw[r * n], n, mode > 0, mode == 2);
  const int err = mode == 0
      ? bitonic_sort_rows(k.data(), ko.data(), rows, n, code<K>(), nullptr)
      : bitonic_sort_rows_kv(k.data(), v.data(), ko.data(), vo.data(), rows, n, code<K>(),
                             code<V>(), mode == 2, nullptr);
  const bool same = err == 0 && std::memcmp(ko.data(), kw.data(), total * 4) == 0 &&
                    (mode == 0 || std::memcmp(vo.data(), vw.data(), total * 4) == 0);
  if (!same)
    std::printf("MISMATCH rows=%lld n=%d mode=%d key type %d value type %d (launch %d)\n",
                rows, n, mode, code<K>(), code<V>(), err);
  return !same;
}

int main(int argc, char** argv) {
  const int max_log_n = std::atoi(argv[1]);
  int bad = 0;
  for (int log_n = 1; log_n <= max_log_n; ++log_n) {
    const int n = 1 << log_n;
    const int per_cta = (sort_threads(log_n) << log_elems(log_n)) / n;
    for (long long rows : {1LL, 3LL, per_cta > 1 ? 2LL * per_cta + 1 : 5LL}) {
      bad += check<float, uint32_t>(rows, n, 0) + check<int32_t, uint32_t>(rows, n, 0) +
             check<uint32_t, uint32_t>(rows, n, 0) + check<float, int32_t>(rows, n, 1) +
             check<float, int32_t>(rows, n, 2) + check<float, float>(rows, n, 2) +
             check<uint32_t, int32_t>(rows, n, 2) + check<int32_t, float>(rows, n, 2);
    }
    std::printf("N=%d: %s\n", n, bad ? "MISMATCH" : "equal to the serial network");
    std::fflush(stdout);
  }
  alignas(16) float x[8] = {};
  if (bitonic_sort_rows(x, x, 1, 3, 2, nullptr) == 0 ||
      bitonic_sort_rows(x + 1, x, 1, 4, 2, nullptr) == 0) {
    std::printf("a bad row length or an unaligned pointer was accepted\n");
    ++bad;
  }
  return bad != 0;
}
"""


def translate(src: str) -> str:
    """The CUDA source as C++ for the emulation above."""
    src = src.replace("#include <cuda_runtime.h>", PRELUDE)
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emul_launch(\1, \2, ", src, flags=re.S)
    return src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                       "unsigned char* smem = g_smem;")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-log-n", type=int, default=13)
    args = ap.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    cpp, exe = OUT / "bitonic_cpu.cpp", OUT / "bitonic_cpu"
    cpp.write_text(translate(SOURCE.read_text()) + HARNESS)
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-Wno-unknown-pragmas",
                    "-o", str(exe), str(cpp)], check=True)
    return subprocess.run([str(exe), str(args.max_log_n)]).returncode


if __name__ == "__main__":
    sys.exit(main())
