// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash.py::_flash_kernel
// (reached through flash_attention, flash.py:90). It computes what that
// kernel computes: causal or full GQA attention, q (B, S, H, dh) against
// k/v (B, T, KV, dh) with H % KV == 0, an online softmax whose state
// (running max m, denominator l, accumulator acc) stays in f32, masked
// scores set to -1e30, fully masked causal key tiles skipped, and the
// output acc / max(l, 1e-30) in the input dtype, laid out (B, S, H, dh).
//
// Grid: one CTA per (q tile, h, b). The TPU's sequential ki grid axis is a
// loop inside the CTA over the key tiles up to the last one that is not
// fully masked (the same block-level skip as k_start <= q_start + bq - 1).
// The K/V head is h / (H / KV), as the BlockSpec index maps take it: no
// head is ever replicated. The kernel computes its own offsets and masks
// the ragged edge, so S and T need not be multiples of a tile.
//
// Bound on this card: at the qwen3-4b prefill shape (B 2, S = T = 8192,
// H 32, KV 8, dh 128, bf16, causal) the useful products are
// 4 * B * H * S^2 * dh / 2 = 1.10e12 operations, 1.11 ms at 989 TFLOP/s
// of dense bf16; the bytes (q, k, v read once, o written once: 0.17 GB)
// take 0.05 ms at 3.35 TB/s. So the tensor cores are the bound, and the
// design keeps every product on them and every intermediate on chip:
//   * bf16 (the path's dtype): 4 warps, each owning 16 query rows of a
//     64-row tile. Q fragments live in registers for the whole key loop.
//     K and V tiles of 64 keys are copied row-major into shared memory
//     with cp.async, two stages deep, so the next tile's copies run under
//     this tile's products. S = Q K^T and O += P V are mma.sync m16n8k16
//     bf16 products with f32 accumulation, their B fragments read with
//     ldmatrix (.trans for V); P passes from the S accumulators to the A
//     operand of the second product in registers (rounded to bf16 there,
//     as the tensor core needs). m and l stay per row in registers; the
//     mask is applied only on tiles that cross the diagonal or the ragged
//     end. The scores never reach device memory.
//   * float32 (accepted so that tests can compare at a tight tolerance):
//     the same schedule with 32x32 tiles, f32 FMA from shared memory.
// What is left for later (ROADMAP): wgmma with TMA loads and a producer
// warp, and larger tiles.
//
// Every entry point returns the cudaError_t of its launch (0 = success)
// and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of repro/kernels/flash.py
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ bf16, mma
constexpr int kBq = 64;     // query rows per CTA
constexpr int kBk = 64;     // keys per tile
constexpr int kWarps = 4;   // 16 query rows per warp
constexpr int kPad = 8;     // bf16 padding per shared row: conflict-free fragments

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Without .trans lane 4g + t receives row g,
// columns 2t and 2t + 1 of each matrix; with .trans, rows 2t and 2t + 1 of
// column g.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16 bytes from global to shared memory without passing through
// registers; zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async_16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Number of key tiles a query tile visits: all of them, or under a causal
// mask those up to the one holding the tile's last valid query position.
__device__ __forceinline__ int key_tiles(int q0, int bq, int S, int T, int bk,
                                         int causal) {
  int n = (T + bk - 1) / bk;
  if (causal) {
    const int last_q = min(q0 + bq, S) - 1;
    n = min(n, last_q / bk + 1);
  }
  return n;
}

// Fragment layouts of m16n8k16 (PTX ISA), lane = 4 * g + t:
//   A (16x16, rows x k): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                        a3 (g+8, 2t+8..)
//   B (16x8, k x cols):  b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g)
//   C (16x8 f32):        c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// K and V tiles are stored row-major, one key per row. For S = Q K^T the B
// operand is K^T, so an ldmatrix without .trans over K rows gives b0/b1;
// for O += P V the B operand is V itself, so ldmatrix .trans over V rows.
template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int S, int T, int H, int KV,
               float scale_log2, int causal) {
  constexpr int RS = DH + kPad;   // shared row stride, in elements
  constexpr int CH = DH / 8;      // 16-byte chunks per row
  constexpr int TILE = kBk * RS;  // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBq * RS;  // two stages
  __nv_bfloat16* Vs = Ks + 2 * TILE;  // two stages

  // the longest causal rows first, so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const long long q_stride = static_cast<long long>(H) * DH;
  const long long kv_stride = static_cast<long long>(KV) * DH;
  const __nv_bfloat16* qb = q + (static_cast<long long>(b) * S * H + h) * DH;
  const __nv_bfloat16* kb = k + (static_cast<long long>(b) * T * KV + kvh) * DH;
  const __nv_bfloat16* vb = v + (static_cast<long long>(b) * T * KV + kvh) * DH;

  // rows past S or T are zero-filled (and masked or never written)
  for (int i = tid; i < kBq * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool in = q0 + r < S;
    cp_async_16(Qs + r * RS + c * 8, qb + (in ? (q0 + r) * q_stride + c * 8 : 0), in);
  }
  auto load_kv = [&](int stage, int k0) {
    for (int i = tid; i < kBk * CH; i += blockDim.x) {
      const int r = i / CH, c = i % CH;  // neighbours copy one row: coalesced
      const bool in = k0 + r < T;
      const long long off = in ? (k0 + r) * kv_stride + c * 8 : 0;
      cp_async_16(Ks + stage * TILE + r * RS + c * 8, kb + off, in);
      cp_async_16(Vs + stage * TILE + r * RS + c * 8, vb + off, in);
    }
  };
  const int n_kt = key_tiles(q0, kBq, S, T, kBk, causal);
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q and the first K/V tile

  // per thread: rows g and g + 8 of the warp's 16; l is this thread's
  // share of the row sum (its 2 columns of each 8), summed over the quad
  // at the end
  const int r0 = warp * 16;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  uint32_t qf[DH / 16][4];
  float acc[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  // the row and column this lane addresses in each ldmatrix x4 (the
  // matrices are listed where they are loaded)
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBk;
    const int stage = kt & 1;
    if (kt + 1 < n_kt) {  // the next tile's copies run under this tile's products
      load_kv(stage ^ 1, k0 + kBk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        qf[kk][0] = ld32(Qs + (r0 + g) * RS + kk * 16 + 2 * t);
        qf[kk][1] = ld32(Qs + (r0 + g + 8) * RS + kk * 16 + 2 * t);
        qf[kk][2] = ld32(Qs + (r0 + g) * RS + kk * 16 + 2 * t + 8);
        qf[kk][3] = ld32(Qs + (r0 + g + 8) * RS + kk * 16 + 2 * t + 8);
      }
    }
    const __nv_bfloat16* Kt = Ks + stage * TILE;
    const __nv_bfloat16* Vt = Vs + stage * TILE;

    // S = Q K^T: one ldmatrix x4 gives b0/b1 of two neighbouring n-tiles
    // (matrices: keys +0..7 at d, +0..7 at d+8, +8..15 at d, +8..15 at d+8)
    float s[kBk / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBk / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, Kt + (np * 16 + k_row) * RS + kk * 16 + k_col);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    const bool edge = k0 + kBk > T || (causal && k0 + kBk - 1 > q0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= T || (causal && col > row)) x = kNegInf;
        }
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      acc[dt][0] *= c0;
      acc[dt][1] *= c0;
      acc[dt][2] *= c1;
      acc[dt][3] *= c1;
    }

    // O += P V: P from the S accumulators (rounded to bf16), V's b0/b1
    // from ldmatrix .trans (matrices: keys +0..7 and +8..15 at d, then
    // the same keys at d+8)
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, Vt + (kk * 16 + v_row) * RS + dp * 16 + v_col);
        mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + (static_cast<long long>(b) * S * H + h) * DH;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * q_stride + col) =
          pack_bf16(acc[dt][0] / d0, acc[dt][1] / d0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + row1 * q_stride + col) =
          pack_bf16(acc[dt][2] / d1, acc[dt][3] / d1);
  }
}

// ------------------------------------------------------------ f32, FMA
constexpr int kFq = 32;  // query rows per CTA
constexpr int kFk = 32;  // keys per tile (= warp width: one lane per key)
constexpr int kFThreads = 256;

template <int DH>
__global__ void __launch_bounds__(kFThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S, int T,
              int H, int KV, float scale_log2, int causal) {
  constexpr int QS = DH + 1;   // padded: lanes reading one column hit distinct banks
  constexpr int PS = kFk + 1;
  constexpr int PER = DH / 8;  // output columns per thread
  extern __shared__ float fsm[];
  float* Qs = fsm;               // [kFq][QS]
  float* Ks = Qs + kFq * QS;     // [kFk][QS]
  float* Vs = Ks + kFk * QS;     // [kFk][DH]
  float* Ps = Vs + kFk * DH;     // [kFq][PS]: scores, then probabilities
  float* ms = Ps + kFq * PS;     // running max per row
  float* ls = ms + kFq;          // running denominator per row
  float* cs = ls + kFq;          // this tile's correction per row

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  const long long q_stride = static_cast<long long>(H) * DH;
  const long long kv_stride = static_cast<long long>(KV) * DH;
  const float* qb = q + (static_cast<long long>(b) * S * H + h) * DH;
  const float* kb = k + (static_cast<long long>(b) * T * KV + kvh) * DH;
  const float* vb = v + (static_cast<long long>(b) * T * KV + kvh) * DH;

  for (int i = tid; i < kFq * DH; i += blockDim.x) {
    const int r = i / DH, d = i % DH;
    Qs[r * QS + d] = q0 + r < S ? qb[(q0 + r) * q_stride + d] : 0.f;
  }
  if (tid < kFq) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  const int pr = tid / 8, pd = tid % 8;  // this thread's output row and column phase
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  const int n_kt = key_tiles(q0, kFq, S, T, kFk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kFk;
    __syncthreads();
    for (int i = tid; i < kFk * DH; i += blockDim.x) {
      const int r = i / DH, d = i % DH;
      const bool in = k0 + r < T;
      Ks[r * QS + d] = in ? kb[(k0 + r) * kv_stride + d] : 0.f;
      Vs[r * DH + d] = in ? vb[(k0 + r) * kv_stride + d] : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < kFq * kFk; i += blockDim.x) {
      const int r = i / kFk, c = i % kFk;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot = fmaf(Qs[r * QS + d], Ks[c * QS + d], dot);
      float x = dot * scale_log2;
      if (k0 + c >= T || (causal && k0 + c > q0 + r)) x = kNegInf;
      Ps[r * PS + c] = x;
    }
    __syncthreads();

    for (int r = warp; r < kFq; r += kFThreads / 32) {
      const float x = Ps[r * PS + lane];
      const float m_old = ms[r];
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m_old, mx);
      const float p = exp2f(x - mn);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[r * PS + lane] = p;
      if (lane == 0) {
        const float c = exp2f(m_old - mn);
        cs[r] = c;
        ls[r] = ls[r] * c + sum;
        ms[r] = mn;
      }
    }
    __syncthreads();

    const float c = cs[pr];
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[j] *= c;
    for (int kc = 0; kc < kFk; ++kc) {
      const float p = Ps[pr * PS + kc];
#pragma unroll
      for (int j = 0; j < PER; ++j) acc[j] = fmaf(p, Vs[kc * DH + pd + 8 * j], acc[j]);
    }
  }
  __syncthreads();
  if (q0 + pr < S) {
    const float den = fmaxf(ls[pr], 1e-30f);
    float* orow = o + (static_cast<long long>(b) * S * H + h) * DH + (q0 + pr) * q_stride;
#pragma unroll
    for (int j = 0; j < PER; ++j) orow[pd + 8 * j] = acc[j] / den;
  }
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KV, float scale_log2,
                        int causal, cudaStream_t stream) {
  // Q, and two stages of K and V
  const size_t smem = static_cast<size_t>(kBq + 4 * kBk) * (DH + kPad) *
                      sizeof(__nv_bfloat16);
  auto kern = flash_fwd_bf16<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBq - 1) / kBq, H, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, T,
      H, KV, scale_log2, causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int T, int H, int KV, float scale_log2,
                       int causal, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kFq + kFk) * (DH + 1) +
                       static_cast<size_t>(kFk) * DH +
                       static_cast<size_t>(kFq) * (kFk + 1) + 3 * kFq) *
                      sizeof(float);
  auto kern = flash_fwd_f32<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kFq - 1) / kFq, H, B);
  kern<<<grid, kFThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T, H, KV,
      scale_log2, causal);
  return cudaGetLastError();
}

#define DISPATCH_DH(dh, D, ...)            \
  switch (dh) {                            \
    case 16: { constexpr int D = 16; __VA_ARGS__ } \
    case 32: { constexpr int D = 32; __VA_ARGS__ } \
    case 64: { constexpr int D = 64; __VA_ARGS__ } \
    case 128: { constexpr int D = 128; __VA_ARGS__ } \
    default: return cudaErrorInvalidValue; \
  }

}  // namespace

extern "C" {

// q (B, S, H, dh), k/v (B, T, KV, dh), o (B, S, H, dh), all contiguous and
// 16-byte aligned. dtype: 0 = bfloat16, 1 = float32 (shared by all four).
// dh in {16, 32, 64, 128}. scale multiplies the scores (dh ** -0.5 by
// default, chosen by the caller).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KV, int dh, int dtype,
                        float scale, int causal, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    DISPATCH_DH(dh, D, return launch_bf16<D>(q, k, v, o, B, S, T, H, KV,
                                             scale_log2, causal, st);)
  }
  if (dtype == 1) {
    DISPATCH_DH(dh, D, return launch_f32<D>(q, k, v, o, B, S, T, H, KV,
                                            scale_log2, causal, st);)
  }
  return cudaErrorInvalidValue;
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
