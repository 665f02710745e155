#!/usr/bin/env python3
"""Run the row-sort and merge kernels of csrc/bitonic.cu on the CPU, one
thread per CUDA thread, and hold them to a serial run of the network.

    python3 tools/bitonic_cpu_check.py [--max-log-n 13]

The CUDA source is translated for g++ (C++20, pthreads): each CTA runs as
one std::thread per CUDA thread, ``__syncthreads()`` is a barrier over
them, ``__syncwarp()`` a barrier over the warp, and a launch a loop over
the CTAs. ``bitonic_sort_rows`` and ``bitonic_sort_rows_kv`` then sort
every row length 2 .. 2^max-log-n, 1, 3 and a number of rows that
leaves the last CTA short, with 4- and 8-byte key/value type pairs
(int32, uint32, float32, int64, float64), stable on and off, on keys
with heavy duplicates, +-0.0, +-inf and NaN (the integer types'
extremes among integers); each output
must equal, bit for bit, the network of
repro/kernels/bitonic.py::_sort_network run serially on the same row.
``bitonic_merge_rows`` and ``bitonic_merge_rows_kv`` then merge rows of
the same lengths and counts, of the same types, from contiguous operands
and from the merge tree's strided views (the even and odd rows of one
array), each held to a serial run of ``_merge_network`` on a ++
reverse(b). It also checks that a bad row length, a row stride that
breaks the 16-byte pieces and an unaligned pointer are refused.

The source is built as the library is (``kernels/build.py``): one object
per unit of ``build.UNITS["bitonic"]``, compiled together, linked into
one program. This checks the kernels' logic (layout, directions,
barriers) and how the units link without a card: not their speed, nor
what only nvcc would refuse. Builds in build/cpu_check/; a few minutes in
all at --max-log-n 13. Needs g++.
"""
from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import build as kbuild  # noqa: E402

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
struct longlong2 { long long x, y; };
struct ulonglong2 { unsigned long long x, y; };
struct double2 { double x, y; };
struct dim3 { unsigned x = 0, y = 0, z = 0; };
static thread_local dim3 threadIdx;
static dim3 blockIdx, blockDim;
static std::barrier<>* g_cta;
static std::vector<std::unique_ptr<std::barrier<>>> g_warps;
static inline void __syncthreads() { g_cta->arrive_and_wait(); }
static inline void __syncwarp() { g_warps[threadIdx.x / 32]->arrive_and_wait(); }
static inline unsigned __float_as_uint(float x) { unsigned u; std::memcpy(&u, &x, 4); return u; }
static inline float __uint_as_float(unsigned u) { float x; std::memcpy(&x, &u, 4); return x; }
static inline long long __double_as_longlong(double x) { long long u; std::memcpy(&u, &x, 8); return u; }
static inline double __longlong_as_double(long long u) { double x; std::memcpy(&x, &u, 8); return x; }
alignas(16) static unsigned char g_smem[1 << 17];
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;
template <class F> static cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
static inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
static inline cudaError_t cudaGetLastError() { return 0; }
static inline const char* cudaGetErrorString(cudaError_t) { return ""; }
template <class F, class... A>
static void emul_launch(F kern, unsigned grid, int threads, size_t smem, cudaStream_t, A... args) {
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
// One stage of the network at distance 2^sub over a row of n, blocks
// ascending iff (lo & span) == 0.
template <class K, class V>
void stage(K* k, V* v, int n, int sub, int span, bool has_v, bool tb) {
  for (int q = 0; q < n / 2; ++q) {
    const int lo = ((q >> sub) << (sub + 1)) | (q & ((1 << sub) - 1)), hi = lo + (1 << sub);
    bool gt = k[lo] > k[hi], lt = k[lo] < k[hi];
    if (has_v && tb) {
      const bool eq = k[lo] == k[hi];
      gt = gt || (eq && v[lo] > v[hi]);
      lt = lt || (eq && v[lo] < v[hi]);
    }
    if ((lo & span) == 0 ? gt : lt) {
      std::swap(k[lo], k[hi]);
      if (has_v) std::swap(v[lo], v[hi]);
    }
  }
}

int log2_of(int n) {
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  return log_n;
}

// _sort_network: phases s = 0 .. log n - 1, span 2^(s+1).
template <class K, class V>
void network(K* k, V* v, int n, bool has_v, bool tb) {
  for (int s = 0; s < log2_of(n); ++s)
    for (int sub = s; sub >= 0; --sub) stage(k, v, n, sub, 2 << s, has_v, tb);
}

// _merge_network: distances n / 2 .. 1 under one ascending span of n.
template <class K, class V>
void merge_network(K* k, V* v, int n, bool has_v, bool tb) {
  for (int sub = log2_of(n) - 1; sub >= 0; --sub) stage(k, v, n, sub, n, has_v, tb);
}

static std::mt19937 rng(1);
template <class T> T special() {
  const int x = int(rng() % 7) - 3;
  if constexpr (std::is_floating_point_v<T>) {
    if (x == 0) return (rng() & 1) ? T(0.0) : T(-0.0);
    if (x == 3) return T(INFINITY);
    if (x == -3) return T(-INFINITY);
    if (x == 2 && (rng() & 1)) return T(NAN);
    return T(x);
  } else {
    if (x == 3) return std::numeric_limits<T>::max();
    if (x == -3) return std::numeric_limits<T>::min();
    return T(x);
  }
}
// The entry points' type codes; an 8-byte integer value that only moves
// goes as int64 (its bits are what count).
template <class T> int code() {
  return std::is_same_v<T, int32_t> ? 0 : std::is_same_v<T, uint32_t> ? 1
       : std::is_same_v<T, float> ? 2 : std::is_same_v<T, double> ? 4 : 3;
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
  const bool same = err == 0 && std::memcmp(ko.data(), kw.data(), total * sizeof(K)) == 0 &&
                    (mode == 0 || std::memcmp(vo.data(), vw.data(), total * sizeof(V)) == 0);
  if (!same)
    std::printf("MISMATCH rows=%lld n=%d mode=%d key type %d value type %d (launch %d)\n",
                rows, n, mode, code<K>(), code<V>(), err);
  return !same;
}

// Merges of rows of n2 / 2 into rows of n2 (mode as above). Contiguous: a
// and b each in an array of its own, row stride n2 / 2; strided: a and b
// are the even and odd rows of one array (the merge tree's views), row
// stride n2. Each a and b row is sorted by the serial network first.
template <class K, class V> int check_merge(long long rows, int n2, int mode, bool strided) {
  const int n = n2 / 2;
  const long long stride = strided ? n2 : n, total = rows * n2;
  std::vector<K> ka(total), kb(total), ko(total), kw(total);
  std::vector<V> va(total), vb(total), vo(total), vw(total);
  for (auto* x : {&ka, &kb}) for (auto& e : *x) e = special<K>();
  for (auto* x : {&va, &vb}) for (auto& e : *x) e = special<V>();
  const K* ak = ka.data();
  const K* bk = strided ? ka.data() + n : kb.data();
  const V* av = va.data();
  const V* bv = strided ? va.data() + n : vb.data();
  for (long long r = 0; r < rows; ++r) {
    network(const_cast<K*>(ak) + r * stride, const_cast<V*>(av) + r * stride, n, mode > 0,
            mode == 2);
    network(const_cast<K*>(bk) + r * stride, const_cast<V*>(bv) + r * stride, n, mode > 0,
            mode == 2);
    for (int i = 0; i < n; ++i) {
      kw[r * n2 + i] = ak[r * stride + i];
      kw[r * n2 + n2 - 1 - i] = bk[r * stride + i];
      vw[r * n2 + i] = av[r * stride + i];
      vw[r * n2 + n2 - 1 - i] = bv[r * stride + i];
    }
    merge_network(&kw[r * n2], &vw[r * n2], n2, mode > 0, mode == 2);
  }
  const int err = mode == 0
      ? bitonic_merge_rows(ak, stride, bk, stride, ko.data(), rows, n, code<K>(), nullptr)
      : bitonic_merge_rows_kv(ak, stride, av, stride, bk, stride, bv, stride, ko.data(),
                              vo.data(), rows, n, code<K>(), code<V>(), mode == 2, nullptr);
  const bool same = err == 0 && std::memcmp(ko.data(), kw.data(), total * sizeof(K)) == 0 &&
                    (mode == 0 || std::memcmp(vo.data(), vw.data(), total * sizeof(V)) == 0);
  if (!same)
    std::printf("MERGE MISMATCH rows=%lld 2n=%d mode=%d strided=%d key type %d value type %d "
                "(launch %d)\n", rows, n2, mode, strided, code<K>(), code<V>(), err);
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
      bad += check<int64_t, uint32_t>(rows, n, 0) + check<double, uint32_t>(rows, n, 0) +
             check<int64_t, int64_t>(rows, n, 1) + check<double, int32_t>(rows, n, 1) +
             check<float, int64_t>(rows, n, 1) + check<int64_t, int64_t>(rows, n, 2) +
             check<double, double>(rows, n, 2) + check<int64_t, float>(rows, n, 2) +
             check<double, uint32_t>(rows, n, 2) + check<float, double>(rows, n, 2) +
             check<uint32_t, int64_t>(rows, n, 2);
    }
    std::printf("N=%d: %s\n", n, bad ? "MISMATCH" : "equal to the serial network");
    std::fflush(stdout);
  }
  for (int log_n2 = 1; log_n2 <= max_log_n; ++log_n2) {
    const int n2 = 1 << log_n2;
    const int per_cta = (sort_threads(log_n2) << log_elems(log_n2)) / n2;
    for (long long rows : {1LL, 3LL, per_cta > 1 ? 2LL * per_cta + 1 : 5LL})
      for (bool strided : {false, true})
        bad += check_merge<float, uint32_t>(rows, n2, 0, strided) +
               check_merge<int32_t, uint32_t>(rows, n2, 0, strided) +
               check_merge<uint32_t, uint32_t>(rows, n2, 0, strided) +
               check_merge<float, int32_t>(rows, n2, 1, strided) +
               check_merge<float, int32_t>(rows, n2, 2, strided) +
               check_merge<float, float>(rows, n2, 2, strided) +
               check_merge<uint32_t, int32_t>(rows, n2, 2, strided) +
               check_merge<int32_t, float>(rows, n2, 2, strided) +
               check_merge<int64_t, uint32_t>(rows, n2, 0, strided) +
               check_merge<double, uint32_t>(rows, n2, 0, strided) +
               check_merge<int64_t, int64_t>(rows, n2, 1, strided) +
               check_merge<double, int32_t>(rows, n2, 1, strided) +
               check_merge<float, int64_t>(rows, n2, 1, strided) +
               check_merge<int64_t, int64_t>(rows, n2, 2, strided) +
               check_merge<double, double>(rows, n2, 2, strided) +
               check_merge<int64_t, float>(rows, n2, 2, strided) +
               check_merge<double, uint32_t>(rows, n2, 2, strided) +
               check_merge<float, double>(rows, n2, 2, strided) +
               check_merge<uint32_t, int64_t>(rows, n2, 2, strided);
    std::printf("merge to 2n=%d: %s\n", n2, bad ? "MISMATCH" : "equal to the serial network");
    std::fflush(stdout);
  }
  alignas(16) float x[64] = {}, out[64];
  if (bitonic_sort_rows(x, x, 1, 3, 2, nullptr) == 0 ||
      bitonic_sort_rows(x + 1, x, 1, 4, 2, nullptr) == 0 ||
      bitonic_merge_rows(x, 3, x, 3, out, 1, 3, 2, nullptr) == 0 ||    // n not a power of 2
      bitonic_merge_rows(x + 1, 8, x, 8, out, 1, 8, 2, nullptr) == 0 ||  // unaligned piece
      bitonic_merge_rows(x, 10, x, 8, out, 2, 8, 2, nullptr) == 0 ||     // stride off pieces
      bitonic_merge_rows(x, 8, x, 8, out + 1, 1, 8, 2, nullptr) == 0) {
    std::printf("a bad row length, stride or unaligned pointer was accepted\n");
    ++bad;
  }
  if (bitonic_merge_rows(x + 1, 5, x + 3, 5, out, 2, 2, 2, nullptr) != 0) {
    std::printf("a merge of rows of 2 read element by element was refused\n");
    ++bad;
  }
  // 8-byte pieces: a row stride of 10 doubles keeps them 16-byte aligned
  // (10 floats would not), 9 does not; type codes past 4 are refused
  alignas(16) double xd[64] = {}, outd[64];
  if (bitonic_merge_rows(xd, 10, xd, 8, outd, 2, 8, 4, nullptr) != 0 ||
      bitonic_merge_rows(xd, 9, xd, 8, outd, 2, 8, 4, nullptr) == 0 ||
      bitonic_merge_rows(xd + 1, 8, xd, 8, outd, 1, 8, 4, nullptr) == 0 ||
      bitonic_sort_rows(xd, outd, 1, 8, 5, nullptr) == 0 ||
      bitonic_sort_rows_kv(xd, xd, outd, outd, 1, 8, 4, 5, 1, nullptr) == 0) {
    std::printf("an 8-byte merge stride, an unaligned 8-byte piece or a bad type code "
                "was judged wrongly\n");
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
    # the library's translation units, as kernels/build.py compiles them
    # (the last holds the entry points, and the harness joins it)
    unit, main_cpp, exe = OUT / "bitonic_unit.cpp", OUT / "bitonic_main.cpp", OUT / "bitonic_cpu"
    src = translate(SOURCE.read_text())
    unit.write_text(src)
    main_cpp.write_text(src + HARNESS)
    gxx = ["g++", "-std=c++20", "-O1", "-pthread", "-Wno-unknown-pragmas", "-c"]
    flags = kbuild.UNITS["bitonic"]
    objs = [OUT / f"unit{u}.o" for u in range(len(flags))]
    procs = [subprocess.Popen([*gxx, d, "-o", str(o), str(main_cpp if u == len(flags) - 1 else unit)])
             for u, (d, o) in enumerate(zip(flags, objs))]
    if any(p.wait() for p in procs):
        return 1
    subprocess.run(["g++", "-pthread", "-o", str(exe), *map(str, objs)], check=True)
    return subprocess.run([str(exe), str(args.max_log_n)]).returncode


if __name__ == "__main__":
    sys.exit(main())
