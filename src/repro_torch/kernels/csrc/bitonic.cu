// Bitonic sorting-network kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the four Pallas TPU kernels of repro/kernels/bitonic.py:
//   bitonic_sort_rows      <- _sort_kernel      (via bitonic_sort_rows)
//   bitonic_sort_rows_kv   <- _sort_kv_kernel   (via bitonic_sort_rows_kv)
//   bitonic_merge_rows     <- _merge_kernel     (via bitonic_merge_rows)
//   bitonic_merge_rows_kv  <- _merge_kv_kernel  (via bitonic_merge_rows_kv)
//
// Each kernel runs the SAME compare-exchange network as the Pallas kernel:
// the same stage order, the same direction rule (_dir_mask: a compare
// block is ascending iff (block_start / span) % 2 == 0; the merge network
// is one ascending span over the whole row) and the same tie rule (with
// a tie-break, equal keys swap iff the values compare the other way).
// Equal keys are not interchangeable (-0.0 == 0.0, and payloads of tied
// keys land where the network puts them), so a different algorithm, such
// as a radix sort or a merge-path merge, would not give the same output.
//
// Row sort (sort_rows_kernel). The row is read from device memory once and
// written once, so bytes do not bound it (2^22 float32 keys are 32 MiB a
// way, about 10 us at 3.35 TB/s, 20 us with int32 values): the network's
// N/2 * log N (log N + 1) / 2 compare-exchanges do, and the compares and
// selects that carry them out all run on the ALU pipe. So each
// compare-exchange is one compare and two selects on registers:
//   - Thread t of a CTA holds E = 2^log_elems(log N) consecutive elements
//     (kElems; twice that for rows of 8192, so that a CTA has at most
//     kMaxThreads threads and 128 registers each), CTA-flat indices
//     f = t * E + r (r < E), loaded and stored with 16-byte accesses. A
//     CTA of sort_threads(log N) threads holds whole rows (several when N
//     is short); bits >= log N of f select the row, and no stage crosses
//     them.
//   - A stage at distance 2^d runs on the registers as they are for
//     d < log E. For the longer distances of a phase, the thread
//     stores its elements to shared memory and reloads them by
//     butterflies: groups of up to log E distances, each thread
//     taking whole butterflies (the 2^G elements those stages pair) into
//     registers, running the stages there and storing them back. A group
//     within the warp's 32 E elements needs __syncwarp(); one that reaches
//     across warps, __syncthreads() (4 a row at N = 1024). The word
//     addresses are swizzled (swz) so that no access pattern has bank
//     conflicts.
//   - From span E on, a block's direction is one per thread for
//     the phase. The elements of a descending block are flipped for the
//     phase by an order-reversing bijection (float: the sign bit, which
//     also keeps -0.0 == +0.0 and NaN unordered; integers: all bits), so
//     every stage compares ascending and the flip is undone exactly.
//   - Everything is unrolled at compile time (templates on log N, the
//     value flag and the tie-break), so every register index is a
//     constant and nothing goes to local memory.
//
// Rows of 4096 and 8192 with 8-byte keys or values are sorted in shared
// memory instead (sort_in_smem): a stage at a time, each thread taking
// pairs, a barrier between stages. A thread would hold 128 or 256 bytes
// of them in the register layout, and ptxas spills there. These rows are
// off the main path (its tiles are 1024 wide); their speed is not tuned.
//
// Merge (merge_rows_kernel): the half-cleaner that merges two sorted rows
// of n (distances n .. 1 under one ascending span of 2n) is the row sort's
// last phase on rows of 2n, so the merge runs that phase alone in the same
// layout. It reads and writes each element once and runs log 2n stages
// (11-13 on the sort's path, against 55-91 in a row sort), so bytes bound
// it on this card. Every block is ascending, so nothing is flipped. A
// thread's E elements of a ++ reverse(b) are one 16-byte-aligned piece of
// a, or of b reversed in registers, read through a row stride per
// operand, so the merge tree's views of every other run are read in
// place, without a copy.
//
// Types: keys and values are int32 (code 0), uint32 (1), float32 (2),
// int64 (3) or float64 (4); uint64 travels as its int64 lane and the
// narrower types widen, both in the Python wrapper. Without a tie-break
// values only move, so they are carried by their bits as uint32 or
// uint64 (5 key types x (keys, kv with each of 2 value widths, kv with
// each of 5 value types) = 40 kernels a row length, for the row sort and
// for the merge). The 8-byte types run the same network in the same
// layout; a 16-byte piece is two of them. Every entry point returns the
// cudaError_t of its launch (0 = success) and never synchronises.
//
// Units: the library is built from this file as 11 translation units,
// compiled in parallel and linked into one shared library
// (repro_torch/kernels/build.py). With -DBITONIC_UNIT=u, unit
// u = 2 * key code + (0: row sorts, 1: merges) instantiates the kernels
// of one key type, and unit kEntryUnit holds the entry points. Without
// the macro one translation unit holds everything.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#ifndef BITONIC_UNIT
#define BITONIC_UNIT -1
#endif
// a unit instantiates a part of what follows, and leaves the rest unused
#pragma nv_diag_suppress 177
#define BITONIC_ENTRY_UNIT 10
#define BITONIC_HAS(u) (BITONIC_UNIT < 0 || BITONIC_UNIT == (u))

namespace {

constexpr int kMaxRow = 8192;
constexpr int kLogMaxRow = 13;
constexpr int kMaxThreads = 512;

// Row-sort layout (tests/test_torch_kernels.py reads these constants;
// kMaxThreads above bounds a row-sort CTA too).
constexpr int kElems = 8;         // consecutive elements a thread holds
constexpr int kLogElems = 3;
constexpr int kWarp = 32;
constexpr int kLogWarp = 5;
constexpr int kMinThreads = 128;  // a CTA's threads when rows are short
static_assert(1 << kLogElems == kElems && 1 << kLogWarp == kWarp && kElems % 4 == 0,
              "elements a thread in 16-byte pieces of 4- and 8-byte types");

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// log2 of the elements a thread holds for rows of 2^log_n: kElems, or
// twice that where kElems would take more than kMaxThreads threads.
__host__ __device__ constexpr int log_elems(int log_n) {
  return (1 << log_n) / kElems > kMaxThreads ? kLogElems + 1 : kLogElems;
}

// Threads of a row-sort CTA: one per 2^log_elems elements of a row, at
// least kMinThreads (then the CTA holds several rows).
__host__ __device__ constexpr int sort_threads(int log_n) {
  return cmax((1 << log_n) >> log_elems(log_n), kMinThreads);
}

// ---------------------------------------------------------------- row sort

// The network's rule for the ordered pair (a at the lower flat index, b at
// the higher): out of order iff a > b in an ascending block and a < b in a
// descending one; with TB, equal keys go by their values the same way.
// Strict comparisons and selects only, never min/max: an element moves
// only where the network swaps it, so -0.0 / +0.0 and NaN stay put.
template <bool TB, typename K, typename V>
__device__ __forceinline__ bool out_of_order(bool asc, K a, K b, V va, V vb) {
  bool gt = a > b;
  bool lt = a < b;
  if constexpr (TB) {
    const bool eq = a == b;
    gt = gt || (eq && va > vb);
    lt = lt || (eq && va < vb);
  }
  return asc ? gt : lt;
}

// One stage at register bit BIT: x[r] against x[r + 2^BIT] for each r
// with that bit clear, in the direction asc[r] (known at compile time).
template <int BIT, bool HAS_V, bool TB, typename K, typename V, int E>
__device__ __forceinline__ void cmpx_regs(K (&k)[E], V (&v)[E], const bool (&asc)[E]) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (r & (1 << BIT)) continue;
    const int h = r + (1 << BIT);
    const bool swap = out_of_order<TB>(asc[r], k[r], k[h], v[r], v[h]);
    const K ka = k[r];
    k[r] = swap ? k[h] : ka;
    k[h] = swap ? ka : k[h];
    if constexpr (HAS_V) {
      const V va = v[r];
      v[r] = swap ? v[h] : va;
      v[h] = swap ? va : v[h];
    }
  }
}

// Stages at register bits HI down to LO.
template <int HI, int LO, bool HAS_V, bool TB, typename K, typename V, int E>
__device__ __forceinline__ void reg_stages(K (&k)[E], V (&v)[E], const bool (&asc)[E]) {
  if constexpr (HI >= LO) {
    cmpx_regs<HI, HAS_V, TB>(k, v, asc);
    reg_stages<HI - 1, LO, HAS_V, TB>(k, v, asc);
  }
}

// An order-reversing bijection, applied where on is set: a < b iff
// flip(a) > flip(b), a == b iff flip(a) == flip(b), flip(flip(x)) == x.
__device__ __forceinline__ float flip_if(float x, bool on) {
  return __uint_as_float(__float_as_uint(x) ^ (static_cast<uint32_t>(on) << 31));
}
__device__ __forceinline__ int32_t flip_if(int32_t x, bool on) { return x ^ -static_cast<int32_t>(on); }
__device__ __forceinline__ uint32_t flip_if(uint32_t x, bool on) { return x ^ (0u - on); }
__device__ __forceinline__ double flip_if(double x, bool on) {
  const unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(x));
  return __longlong_as_double(static_cast<long long>(b ^ (static_cast<unsigned long long>(on) << 63)));
}
__device__ __forceinline__ int64_t flip_if(int64_t x, bool on) { return x ^ -static_cast<int64_t>(on); }

// The slot in shared memory of CTA-flat index a: bits 2-4 XORed with a
// linear function of bits 5-7, so that at kElems 4-byte elements a thread
// the 16-byte pieces of a thread's own elements and every group's
// butterflies (below) are free of bank conflicts (at 16, two group shapes
// are 2-way; 8-byte elements are not tuned). Bits 0-1 stay, so a piece
// stays whole and aligned. Linear over XOR: swz(a ^ b) == swz(a) ^ swz(b).
__host__ __device__ constexpr int swz(int a) {
  const int x = (a >> 5) & 7;
  return a ^ (((x ^ (x << 1)) & 7) << 2);
}

// A 16-byte piece: kPiece<T> consecutive elements (4 of 4 bytes, 2 of 8),
// moved with one vector access.
template <typename T> struct Piece;
template <> struct Piece<int32_t> { using type = int4; };
template <> struct Piece<uint32_t> { using type = uint4; };
template <> struct Piece<float> { using type = float4; };
template <> struct Piece<int64_t> { using type = longlong2; };
template <> struct Piece<uint64_t> { using type = ulonglong2; };
template <> struct Piece<double> { using type = double2; };
template <typename T> constexpr int kPiece = 16 / static_cast<int>(sizeof(T));

// One piece between memory (16-byte aligned) and x[at .. at + kPiece<T> - 1].
template <typename T, int E>
__device__ __forceinline__ void load_piece(T (&x)[E], int at, const T* p) {
  using W = typename Piece<T>::type;
  const W w = *reinterpret_cast<const W*>(p);
  x[at] = w.x;
  x[at + 1] = w.y;
  if constexpr (kPiece<T> == 4) {
    x[at + 2] = w.z;
    x[at + 3] = w.w;
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_piece(T* p, const T (&x)[E], int at) {
  using W = typename Piece<T>::type;
  W w;
  w.x = x[at];
  w.y = x[at + 1];
  if constexpr (kPiece<T> == 4) {
    w.z = x[at + 2];
    w.w = x[at + 3];
  }
  *reinterpret_cast<W*>(p) = w;
}

// A thread's elements from device memory: elements past the last row (a
// short last CTA, or rows of fewer than E) read as 0 and are never
// stored, and no stage pairs them with an element of a real row.
template <typename T, int E>
__device__ __forceinline__ void load_part(T (&x)[E], const T* src, long long g0,
                                          long long total) {
  if (g0 + E <= total) {
#pragma unroll
    for (int i = 0; i < E; i += kPiece<T>) load_piece(x, i, src + g0 + i);
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) x[r] = g0 + r < total ? src[g0 + r] : T(0);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_part(T* dst, const T (&x)[E], long long g0,
                                           long long total) {
  if (g0 + E <= total) {
#pragma unroll
    for (int i = 0; i < E; i += kPiece<T>) store_piece(dst + g0 + i, x, i);
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r)
      if (g0 + r < total) dst[g0 + r] = x[r];
  }
}

// A thread's own elements (f0 .. f0 + E - 1) to and from shared memory.
template <typename T, int E>
__device__ __forceinline__ void store_own(T* s, const T (&x)[E], int f0) {
#pragma unroll
  for (int i = 0; i < E; i += kPiece<T>) store_piece(s + swz(f0 + i), x, i);
}

template <typename T, int E>
__device__ __forceinline__ void load_own(T (&x)[E], const T* s, int f0) {
#pragma unroll
  for (int i = 0; i < E; i += kPiece<T>) load_piece(x, i, s + swz(f0 + i));
}

template <bool CTA>
__device__ __forceinline__ void sync() {
  if constexpr (CTA) __syncthreads(); else __syncwarp();
}

// Stages at bits HI down to LO (HI - LO < log E) of a phase, with the
// CTA's elements in shared memory, all ascending. Butterfly q (the 2^G
// elements at base + c * 2^LO, c < 2^G, that these stages pair) goes to
// one thread, E / 2^G butterflies a thread: the CTA's butterflies in
// turn when HI is a warp bit, else the butterflies of the thread's own
// warp's 32 E elements, so that __syncwarp() suffices. Then the next group.
template <int LOG_N, int HI, bool HAS_V, bool TB, typename K, typename V, int E>
__device__ __forceinline__ void smem_group(K (&k)[E], V (&v)[E], K* sk, V* sv, int t) {
  constexpr int T = sort_threads(LOG_N);
  constexpr int LE = log_elems(LOG_N);
  constexpr int LO = cmax(HI - LE + 1, LE);
  constexpr int G = HI - LO + 1;
  constexpr bool kCta = HI >= LE + kLogWarp;
  // register r holds element c = r % 2^G of butterfly i = r / 2^G, at
  // word base[i] ^ swz(c << LO) (swz is linear, and base has zeros there)
  int base[E >> G];
  bool asc[E];
#pragma unroll
  for (int i = 0; i < (E >> G); ++i) {
    const int q = kCta ? t + i * T
                       : (t >> kLogWarp) * (kWarp * E >> G) + (t & (kWarp - 1)) + i * kWarp;
    base[i] = swz(((q >> LO) << (LO + G)) | (q & ((1 << LO) - 1)));
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int at = base[r >> G] ^ swz((r & ((1 << G) - 1)) << LO);
    k[r] = sk[at];
    if constexpr (HAS_V) v[r] = sv[at];
    asc[r] = true;
  }
  reg_stages<G - 1, 0, HAS_V, TB>(k, v, asc);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int at = base[r >> G] ^ swz((r & ((1 << G) - 1)) << LO);
    sk[at] = k[r];
    if constexpr (HAS_V) sv[at] = v[r];
  }
  sync<kCta>();
  if constexpr (LO > LE) smem_group<LOG_N, LO - 1, HAS_V, TB>(k, v, sk, sv, t);
}

// Phase S of the network (span 2^(S+1), distances 2^S down to 1). flip
// says whether the thread's elements are flipped, on entry and on exit.
template <int LOG_N, int S, bool HAS_V, bool TB, typename K, typename V, int E>
__device__ __forceinline__ void sort_phase(K (&k)[E], V (&v)[E], K* sk, V* sv, int t,
                                           bool& flip) {
  constexpr int LE = log_elems(LOG_N);
  constexpr int kSpan = 2 << S;
  constexpr bool kWhole = S == LOG_N - 1;  // the last phase is one ascending block
  const int f0 = t * E;
  bool asc[E];
  if constexpr (kSpan < E) {  // a direction per register pair
#pragma unroll
    for (int r = 0; r < E; ++r) asc[r] = kWhole || (r & kSpan) == 0;
  } else {  // one direction for the thread: flip descending blocks
    const bool want = !kWhole && (f0 & kSpan) != 0;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      k[r] = flip_if(k[r], want != flip);
      if constexpr (TB) v[r] = flip_if(v[r], want != flip);
      asc[r] = true;
    }
    flip = want;
  }
  if constexpr (S >= LE) {
    // Each thread stores and reloads only its own elements, so the next
    // phase's store needs no barrier before it.
    store_own(sk, k, f0);
    if constexpr (HAS_V) store_own(sv, v, f0);
    sync<(S >= LE + kLogWarp)>();
    smem_group<LOG_N, S, HAS_V, TB>(k, v, sk, sv, t);
    load_own(k, sk, f0);
    if constexpr (HAS_V) load_own(v, sv, f0);
  }
  reg_stages<cmin(S, LE - 1), 0, HAS_V, TB>(k, v, asc);
}

template <int LOG_N, int S, bool HAS_V, bool TB, typename K, typename V, int E>
__device__ __forceinline__ void sort_phases(K (&k)[E], V (&v)[E], K* sk, V* sv, int t,
                                            bool& flip) {
  if constexpr (S < LOG_N) {
    sort_phase<LOG_N, S, HAS_V, TB>(k, v, sk, sv, t, flip);
    sort_phases<LOG_N, S + 1, HAS_V, TB>(k, v, sk, sv, t, flip);
  }
}

// Does the row sort of rows of 2^LOG_N run in shared memory
// (sort_in_smem below)? Rows of 4096 and 8192 holding 8-byte keys or
// values: in the register layout a thread holds 8 or 16 of them, and
// ptxas spills there at 128 registers a thread (the merges, one phase,
// fit).
template <int LOG_N, bool HAS_V, typename K, typename V>
__host__ __device__ constexpr bool sort_in_smem() {
  return LOG_N >= 12 && (sizeof(K) == 8 || (HAS_V && sizeof(V) == 8));
}

// The same network with the CTA's elements in shared memory: each stage
// one compare-exchange of two shared-memory slots per pair, the pairs
// spread over the threads, a barrier between stages. Elements past the
// last row read as 0 and are never stored.
template <int LOG_N, bool HAS_V, bool TB, typename K, typename V>
__device__ __forceinline__ void sort_in_smem(const K* kin, const V* vin, K* kout, V* vout,
                                             K* sk, V* sv, long long total) {
  constexpr int T = sort_threads(LOG_N);
  constexpr int B = T << log_elems(LOG_N);
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * B;
  for (int i = t; i < B; i += T) {
    sk[i] = base + i < total ? kin[base + i] : K(0);
    if constexpr (HAS_V) sv[i] = base + i < total ? vin[base + i] : V(0);
  }
  __syncthreads();
  for (int s = 0; s < LOG_N; ++s) {
    for (int j = s; j >= 0; --j) {
      for (int q = t; q < B / 2; q += T) {
        const int lo = ((q >> j) << (j + 1)) | (q & ((1 << j) - 1));
        const int hi = lo + (1 << j);
        const bool asc = s == LOG_N - 1 || (lo & (2 << s)) == 0;
        const K a = sk[lo], b = sk[hi];
        V va{}, vb{};
        if constexpr (HAS_V) {
          va = sv[lo];
          vb = sv[hi];
        }
        if (out_of_order<TB>(asc, a, b, va, vb)) {
          sk[lo] = b;
          sk[hi] = a;
          if constexpr (HAS_V) {
            sv[lo] = vb;
            sv[hi] = va;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = t; i < B; i += T) {
    if (base + i < total) {
      kout[base + i] = sk[i];
      if constexpr (HAS_V) vout[base + i] = sv[i];
    }
  }
}

// Full bitonic sort network, ascending: for s in 0..k-1, span 2^(s+1),
// distances 2^s down to 1 (repro/kernels/bitonic.py::_sort_network), over
// rows of N = 2^LOG_N; total = rows * N.
template <int LOG_N, bool HAS_V, bool TB, typename K, typename V>
__global__ void __launch_bounds__(sort_threads(LOG_N))
sort_rows_kernel(const K* __restrict__ kin, const V* __restrict__ vin,
                 K* __restrict__ kout, V* __restrict__ vout, long long total) {
  constexpr int E = 1 << log_elems(LOG_N);
  constexpr int B = sort_threads(LOG_N) * E;
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  V* sv = reinterpret_cast<V*>(smem + B * sizeof(K));
  if constexpr (sort_in_smem<LOG_N, HAS_V, K, V>()) {
    sort_in_smem<LOG_N, HAS_V, TB>(kin, vin, kout, vout, sk, sv, total);
  } else {
    const int t = threadIdx.x;
    const long long g0 = static_cast<long long>(blockIdx.x) * B + t * E;
    K k[E];
    V v[E];
    load_part(k, kin, g0, total);
    if constexpr (HAS_V) load_part(v, vin, g0, total);
    bool flip = false;  // the last phase leaves every element unflipped
    sort_phases<LOG_N, 0, HAS_V, TB>(k, v, sk, sv, t, flip);
    store_part(kout, k, g0, total);
    if constexpr (HAS_V) store_part(vout, v, g0, total);
  }
}

// A thread's elements of a ++ reverse(b), for rows of 2n = 2^LOG_N2
// (sa, sb: the row strides of a and b, in elements). Where E divides n they
// are one piece of a, or of b backwards: E consecutive elements read with
// 16-byte loads (the entry points refuse an operand that is not aligned for
// them) and, for b, reversed in registers. Elements past the last row read
// as 0 and are never stored.
template <int LOG_N2, typename T, int E>
__device__ __forceinline__ void load_merge(T (&x)[E], const T* a, long long sa,
                                           const T* b, long long sb, long long g0,
                                           long long total) {
  constexpr int N = 1 << (LOG_N2 - 1);
  if constexpr (N % E == 0) {
    if (g0 < total) {
      const long long row = g0 >> LOG_N2;
      const int p = static_cast<int>(g0 & (2 * N - 1));
      const bool from_b = p >= N;
      const T* src = from_b ? b + row * sb + (2 * N - E - p) : a + row * sa + p;
      T y[E];
#pragma unroll
      for (int i = 0; i < E; i += kPiece<T>) load_piece(y, i, src + i);
#pragma unroll
      for (int r = 0; r < E; ++r) x[r] = from_b ? y[E - 1 - r] : y[r];
    } else {
#pragma unroll
      for (int r = 0; r < E; ++r) x[r] = T(0);
    }
  } else {  // a thread holds several rows of 2n < 2E
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const long long g = g0 + r;
      const long long row = g >> LOG_N2;
      const int p = static_cast<int>(g & (2 * N - 1));
      x[r] = g >= total ? T(0) : p < N ? a[row * sa + p] : b[row * sb + (2 * N - 1 - p)];
    }
  }
}

// Merge of two sorted rows of n into rows of 2n = 2^LOG_N2: a ++ reverse(b)
// is bitonic, then the half-cleaner stages at distances n .. 1 under one
// ascending span of 2n (repro/kernels/bitonic.py::_merge_network), which
// are the row sort's last phase; total = rows * 2n.
template <int LOG_N2, bool HAS_V, bool TB, typename K, typename V>
__global__ void __launch_bounds__(sort_threads(LOG_N2))
merge_rows_kernel(const K* __restrict__ ak, long long sak, const V* __restrict__ av,
                  long long sav, const K* __restrict__ bk, long long sbk,
                  const V* __restrict__ bv, long long sbv, K* __restrict__ kout,
                  V* __restrict__ vout, long long total) {
  constexpr int E = 1 << log_elems(LOG_N2);
  constexpr int B = sort_threads(LOG_N2) * E;
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  V* sv = reinterpret_cast<V*>(smem + B * sizeof(K));
  const int t = threadIdx.x;
  const long long g0 = static_cast<long long>(blockIdx.x) * B + t * E;
  K k[E];
  V v[E];
  load_merge<LOG_N2>(k, ak, sak, bk, sbk, g0, total);
  if constexpr (HAS_V) load_merge<LOG_N2>(v, av, sav, bv, sbv, g0, total);
  bool flip = false;  // every block of the last phase is ascending: no flips
  sort_phase<LOG_N2, LOG_N2 - 1, HAS_V, TB>(k, v, sk, sv, t, flip);
  store_part(kout, k, g0, total);
  if constexpr (HAS_V) store_part(vout, v, g0, total);
}

// Bytes of an element of type code `code` (see DISPATCH_TYPE), 0 if none.
inline int type_bytes(int code) {
  return code >= 0 && code <= 2 ? 4 : code >= 3 && code <= 4 ? 8 : 0;
}

constexpr int kMaxDevices = 64;

// Lets kern use smem bytes of dynamic shared memory on the current device
// when that is over the default 48 KB: cudaFuncSetAttribute once per
// device, whose outcome every later launch there returns too. `cap` is the
// launcher's static, one per kernel instantiation.
struct SmemCap {
  std::once_flag once[kMaxDevices];
  cudaError_t err[kMaxDevices] = {};
};

template <typename F>
cudaError_t allow_smem(SmemCap& cap, F kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(cap.once[dev], [&] {
    cap.err[dev] = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  });
  return cap.err[dev];
}

// Dynamic shared memory of a row-sort or merge CTA for rows of 2^LOG_N:
// only where a phase has stages past the registers.
template <int LOG_N, bool HAS_V, typename K, typename V>
constexpr size_t smem_bytes() {
  return LOG_N > log_elems(LOG_N)
      ? static_cast<size_t>(sort_threads(LOG_N) << log_elems(LOG_N)) *
            (sizeof(K) + (HAS_V ? sizeof(V) : 0))
      : 0;
}

// CTAs for `rows` rows of 2^LOG_N, sort_threads(LOG_N) << log_elems(LOG_N)
// elements a CTA.
template <int LOG_N>
unsigned ctas(long long rows) {
  constexpr int per_cta = (sort_threads(LOG_N) << log_elems(LOG_N)) >> LOG_N;
  return static_cast<unsigned>((rows + per_cta - 1) / per_cta);
}

}  // namespace

namespace bitonic_units {

// The operands of a row-sort launch.
struct SortArgs {
  const void* k;
  const void* v;
  void* ok;
  void* ov;
  long long rows;
  int log_n;
  bool has_v;
  bool stable;
  int value_type;
  cudaStream_t stream;
};

// The operands of a merge launch: a's and b's keys and values, each with
// its row stride in elements, and the contiguous outputs.
struct MergeArgs {
  const void* ak;
  long long sak;
  const void* av;
  long long sav;
  const void* bk;
  long long sbk;
  const void* bv;
  long long sbv;
  void* ok;
  void* ov;
  long long rows;
  int log_n2;
  bool has_v;
  bool stable;
  int value_type;
  cudaStream_t stream;
};

// Every launch of one key type: defined in that type's unit.
template <typename K> cudaError_t sort_rows(const SortArgs& a);
template <typename K> cudaError_t merge_rows(const MergeArgs& m);
template <> cudaError_t sort_rows<int32_t>(const SortArgs& a);
template <> cudaError_t sort_rows<uint32_t>(const SortArgs& a);
template <> cudaError_t sort_rows<float>(const SortArgs& a);
template <> cudaError_t sort_rows<int64_t>(const SortArgs& a);
template <> cudaError_t sort_rows<double>(const SortArgs& a);
template <> cudaError_t merge_rows<int32_t>(const MergeArgs& m);
template <> cudaError_t merge_rows<uint32_t>(const MergeArgs& m);
template <> cudaError_t merge_rows<float>(const MergeArgs& m);
template <> cudaError_t merge_rows<int64_t>(const MergeArgs& m);
template <> cudaError_t merge_rows<double>(const MergeArgs& m);

}  // namespace bitonic_units

namespace {

using bitonic_units::MergeArgs;
using bitonic_units::SortArgs;

template <int LOG_N, bool HAS_V, bool TB, typename K, typename V>
cudaError_t launch_sort_n(const SortArgs& a) {
  constexpr size_t smem = smem_bytes<LOG_N, HAS_V, K, V>();
  auto kern = sort_rows_kernel<LOG_N, HAS_V, TB, K, V>;
  static SmemCap cap;
  const cudaError_t err = allow_smem(cap, kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<ctas<LOG_N>(a.rows), sort_threads(LOG_N), smem, a.stream>>>(
      static_cast<const K*>(a.k), static_cast<const V*>(a.v), static_cast<K*>(a.ok),
      static_cast<V*>(a.ov), a.rows << LOG_N);
  return cudaGetLastError();
}

template <bool HAS_V, bool TB, typename K, typename V, int LOG_N = 1>
cudaError_t launch_sort(const SortArgs& a) {
  if constexpr (LOG_N > kLogMaxRow) {
    return cudaErrorInvalidValue;
  } else {
    if (a.log_n == LOG_N) return launch_sort_n<LOG_N, HAS_V, TB, K, V>(a);
    return launch_sort<HAS_V, TB, K, V, LOG_N + 1>(a);
  }
}

template <int LOG_N2, bool HAS_V, bool TB, typename K, typename V>
cudaError_t launch_merge_n(const MergeArgs& m) {
  constexpr size_t smem = smem_bytes<LOG_N2, HAS_V, K, V>();
  auto kern = merge_rows_kernel<LOG_N2, HAS_V, TB, K, V>;
  static SmemCap cap;
  const cudaError_t err = allow_smem(cap, kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<ctas<LOG_N2>(m.rows), sort_threads(LOG_N2), smem, m.stream>>>(
      static_cast<const K*>(m.ak), m.sak, static_cast<const V*>(m.av), m.sav,
      static_cast<const K*>(m.bk), m.sbk, static_cast<const V*>(m.bv), m.sbv,
      static_cast<K*>(m.ok), static_cast<V*>(m.ov), m.rows << LOG_N2);
  return cudaGetLastError();
}

template <bool HAS_V, bool TB, typename K, typename V, int LOG_N = 1>
cudaError_t launch_merge(const MergeArgs& m) {
  if constexpr (LOG_N > kLogMaxRow) {
    return cudaErrorInvalidValue;
  } else {
    if (m.log_n2 == LOG_N) return launch_merge_n<LOG_N, HAS_V, TB, K, V>(m);
    return launch_merge<HAS_V, TB, K, V, LOG_N + 1>(m);
  }
}

// Type codes shared with repro_torch/kernels/bitonic.py::_TYPE_CODES.
#define DISPATCH_TYPE(code, T, ...)            \
  switch (code) {                              \
    case 0: { using T = int32_t; __VA_ARGS__ }  \
    case 1: { using T = uint32_t; __VA_ARGS__ } \
    case 2: { using T = float; __VA_ARGS__ }    \
    case 3: { using T = int64_t; __VA_ARGS__ }  \
    case 4: { using T = double; __VA_ARGS__ }   \
    default: return cudaErrorInvalidValue;     \
  }

// Every variant of one key type: keys only; values that only move (by
// their bits, 4 or 8 bytes); values that break ties (each value type).
template <template <bool, bool, typename, typename> class L, typename K, typename A>
cudaError_t variants(const A& a) {
  if (!a.has_v) return L<false, false, K, uint32_t>::run(a);
  if (!a.stable) {
    if (type_bytes(a.value_type) == 8) return L<true, false, K, uint64_t>::run(a);
    return L<true, false, K, uint32_t>::run(a);
  }
  DISPATCH_TYPE(a.value_type, V, return L<true, true, K, V>::run(a);)
}

template <bool HAS_V, bool TB, typename K, typename V>
struct SortLaunch {
  static cudaError_t run(const SortArgs& a) { return launch_sort<HAS_V, TB, K, V>(a); }
};

template <bool HAS_V, bool TB, typename K, typename V>
struct MergeLaunch {
  static cudaError_t run(const MergeArgs& m) { return launch_merge<HAS_V, TB, K, V>(m); }
};

}  // namespace

namespace bitonic_units {

#if BITONIC_HAS(0)
template <> cudaError_t sort_rows<int32_t>(const SortArgs& a) { return variants<SortLaunch, int32_t>(a); }
#endif
#if BITONIC_HAS(1)
template <> cudaError_t merge_rows<int32_t>(const MergeArgs& m) { return variants<MergeLaunch, int32_t>(m); }
#endif
#if BITONIC_HAS(2)
template <> cudaError_t sort_rows<uint32_t>(const SortArgs& a) { return variants<SortLaunch, uint32_t>(a); }
#endif
#if BITONIC_HAS(3)
template <> cudaError_t merge_rows<uint32_t>(const MergeArgs& m) { return variants<MergeLaunch, uint32_t>(m); }
#endif
#if BITONIC_HAS(4)
template <> cudaError_t sort_rows<float>(const SortArgs& a) { return variants<SortLaunch, float>(a); }
#endif
#if BITONIC_HAS(5)
template <> cudaError_t merge_rows<float>(const MergeArgs& m) { return variants<MergeLaunch, float>(m); }
#endif
#if BITONIC_HAS(6)
template <> cudaError_t sort_rows<int64_t>(const SortArgs& a) { return variants<SortLaunch, int64_t>(a); }
#endif
#if BITONIC_HAS(7)
template <> cudaError_t merge_rows<int64_t>(const MergeArgs& m) { return variants<MergeLaunch, int64_t>(m); }
#endif
#if BITONIC_HAS(8)
template <> cudaError_t sort_rows<double>(const SortArgs& a) { return variants<SortLaunch, double>(a); }
#endif
#if BITONIC_HAS(9)
template <> cudaError_t merge_rows<double>(const MergeArgs& m) { return variants<MergeLaunch, double>(m); }
#endif

}  // namespace bitonic_units

#if BITONIC_HAS(BITONIC_ENTRY_UNIT)

namespace {

int ilog2(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

bool bad_shape(long long rows, int n) {
  return rows <= 0 || rows > 0x7fffffffLL || n < 2 || n > kMaxRow ||
         (n & (n - 1)) != 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// An operand of a merge: rows of n elements of `bytes` bytes at a row
// stride of `stride` elements. Where a thread's elements are one piece of
// it (E divides n), the piece is read 16 bytes at a time, so its start
// and its stride must keep every piece 16-byte aligned.
bool bad_operand(const void* p, long long stride, int n, int bytes) {
  const bool pieces = n % (1 << log_elems(ilog2(2 * n))) == 0;
  return stride < 0 || (pieces && (!aligned16(p) || (stride * bytes) % 16 != 0));
}

}  // namespace

extern "C" {

int bitonic_sort_rows(const void* keys, void* out, long long rows, int n,
                      int key_type, void* stream) {
  if (bad_shape(rows, n) || !aligned16(keys) || !aligned16(out))
    return cudaErrorInvalidValue;
  const SortArgs a{keys, nullptr, out, nullptr, rows, ilog2(n), false, false, 0,
                   static_cast<cudaStream_t>(stream)};
  DISPATCH_TYPE(key_type, K, return bitonic_units::sort_rows<K>(a);)
}

int bitonic_sort_rows_kv(const void* keys, const void* values, void* out_keys,
                         void* out_values, long long rows, int n, int key_type,
                         int value_type, int stable, void* stream) {
  if (bad_shape(rows, n) || !aligned16(keys) || !aligned16(values) ||
      !aligned16(out_keys) || !aligned16(out_values) || !type_bytes(value_type))
    return cudaErrorInvalidValue;
  // without a tie-break values only move: their type does not matter, their bits do
  const SortArgs a{keys, values, out_keys, out_values, rows, ilog2(n), true, stable != 0,
                   value_type, static_cast<cudaStream_t>(stream)};
  DISPATCH_TYPE(key_type, K, return bitonic_units::sort_rows<K>(a);)
}

// a and b: rows of n at row strides a_stride and b_stride (elements; the
// last dimension is unit-stride); out: rows of 2n, contiguous.
int bitonic_merge_rows(const void* a, long long a_stride, const void* b,
                       long long b_stride, void* out, long long rows, int n,
                       int key_type, void* stream) {
  const int kb = type_bytes(key_type);
  if (!kb || n < 1 || n > kMaxRow / 2 || bad_shape(rows, 2 * n) ||
      bad_operand(a, a_stride, n, kb) || bad_operand(b, b_stride, n, kb) || !aligned16(out))
    return cudaErrorInvalidValue;
  const MergeArgs m{a, a_stride, nullptr, 0, b, b_stride, nullptr, 0, out, nullptr,
                    rows, ilog2(2 * n), false, false, 0, static_cast<cudaStream_t>(stream)};
  DISPATCH_TYPE(key_type, K, return bitonic_units::merge_rows<K>(m);)
}

int bitonic_merge_rows_kv(const void* ak, long long ak_stride, const void* av,
                          long long av_stride, const void* bk, long long bk_stride,
                          const void* bv, long long bv_stride, void* out_keys,
                          void* out_values, long long rows, int n, int key_type,
                          int value_type, int stable, void* stream) {
  const int kb = type_bytes(key_type), vb = type_bytes(value_type);
  if (!kb || !vb || n < 1 || n > kMaxRow / 2 || bad_shape(rows, 2 * n) ||
      bad_operand(ak, ak_stride, n, kb) || bad_operand(av, av_stride, n, vb) ||
      bad_operand(bk, bk_stride, n, kb) || bad_operand(bv, bv_stride, n, vb) ||
      !aligned16(out_keys) || !aligned16(out_values))
    return cudaErrorInvalidValue;
  const MergeArgs m{ak, ak_stride, av, av_stride, bk, bk_stride, bv, bv_stride,
                    out_keys, out_values, rows, ilog2(2 * n), true, stable != 0, value_type,
                    static_cast<cudaStream_t>(stream)};
  DISPATCH_TYPE(key_type, K, return bitonic_units::merge_rows<K>(m);)
}

const char* bitonic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // BITONIC_HAS(BITONIC_ENTRY_UNIT)
