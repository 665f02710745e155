// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash.py::_flash_kernel
// (reached through flash_attention, flash.py:90). It computes what that
// kernel computes: causal or full GQA attention, q (B, S, H, dqk) against
// k (B, T, KV, dqk) and v (B, T, KV, dv) with H % KV == 0, an online
// softmax whose state (running max m, denominator l, accumulator acc) stays
// in f32, masked scores set to -1e30, fully masked causal key tiles
// skipped, and the output acc / max(l, 1e-30) in the input dtype, laid out
// (B, S, H, dv). dv = dqk except for MLA (deepseek-v3): q and k 192 wide
// (128 nope + 64 rope), v 128 wide, H = KV = 128, which repro computes off
// the TPU through _flash_attn_pairs (models/attention.py), whose value
// width is v's own.
//
// Grid: one CTA per (q tile, h, b), the longest causal rows first. The
// TPU's sequential ki grid axis is a loop inside the CTA over the key tiles
// up to the last one that is not fully masked (the same block-level skip
// as k_start <= q_start + bq - 1). The K/V head is h / (H / KV), as the
// BlockSpec index maps take it: no head is ever replicated. The kernel
// masks the ragged edge itself, so S and T need not be multiples of a tile.
//
// Bound on this card: at the qwen3-4b prefill shape (B 2, S = T = 8192,
// H 32, KV 8, dh 128, bf16, causal) the useful products are
// 4 * B * H * S^2 * dh / 2 = 1.10e12 operations, 1.11 ms at 989 TFLOP/s
// of dense bf16; the bytes (q, k, v read once, o written once: 0.17 GB)
// take 0.05 ms at 3.35 TB/s. At MLA's prefill (B 1, S = T = 8192, H 128,
// dqk 192, dv 128) the products are 2 * H * S^2 / 2 * (dqk + dv) = 2.75e12
// operations, 2.78 ms at 989 TFLOP/s. So the tensor cores are the bound,
// and every route keeps every product on them (or, in f32, on the FMA
// units) and every intermediate on chip. Three routes, chosen by dtype and
// the widths (dqk, dv):
//   * bf16, (64, 64), (128, 128) and MLA's (192, 128) (every served model):
//     wgmma. Three warpgroups:
//     warpgroup 0 is the producer, one thread of which issues TMA loads
//     (Q once; K and V through a ring of kStages tiles of kWgBk keys, each
//     slot with a "full" and an "empty" mbarrier; at (192, 128) the ring
//     holds two tiles, ring_stages); warpgroups 1 and 2 each
//     own 64 rows of the 128-row query tile. S = Q K^T is wgmma m64nBk k16
//     with both operands in 128-byte-swizzled shared memory (K-major);
//     O += P V is the register-A form, P packed to bf16 straight from the
//     S accumulators (whose layout is the A fragment's) and V read
//     MN-major through the transpose bit, never transposed in memory.
//     setmaxnreg moves registers from the producer to the consumers. The
//     consumers take turns (two named barriers) to issue tile kt's Q K^T
//     and tile kt - 1's P V together, and tile kt's mask and row max run
//     under that P V, so the tensor cores wait less on the softmax.
//   * bf16, (16, 16) and (32, 32) (test shapes only): mma.sync m16n8k16, 4 warps
//     over a 64-row tile, 64-key tiles double-buffered with cp.async,
//     B fragments by ldmatrix (.trans for V).
//   * float32, every pair above (accepted so that tests and the card's
//     checks can compare at a tight tolerance): 32x32 tiles, f32 FMA from
//     shared memory.
// In every bf16 route p is rounded to bf16 as the A operand of PV, l sums
// the unrounded p, m and l stay per row in registers, and the mask is
// applied only on tiles that cross the diagonal or the ragged end.
//
// Every entry point returns the cudaError_t of its launch (0 = success),
// or kTmaEncodeFailed + the CUresult of a failed tensor-map encode, and
// never synchronises.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

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

// ------------------------------------------------- bf16, wgmma (dh 64, 128)
constexpr int kWgBq = 128;       // query rows per CTA: two consumer warpgroups of 64
constexpr int kWgBk = 128;       // keys per tile
constexpr int kStages = 3;       // K/V tiles in the ring: two in use, one loading
constexpr int kWgThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kSwz = 64;         // bf16 in a 128-byte swizzled row: one TMA box's width
constexpr int kTmaEncodeFailed = 100000;  // + CUresult: a tensor map was refused
constexpr int kSmemMax = 232448;  // shared memory a block may have

// The ring's depth for Q of q_bytes and K + V tiles of kv_bytes: kStages
// where they fit in a block's shared memory, else two. (64, 64) and
// (128, 128) keep three; MLA's (192, 128) tiles (Q 48 KB, K 48 KB, V 32 KB)
// would need 288 KB at three and take 208 KB at two.
constexpr int ring_stages(int q_bytes, int kv_bytes) {
  return 1024 + q_bytes + kStages * kv_bytes + 8 * (1 + 2 * kStages) <= kSmemMax ? kStages : 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory. The mbarrier counts it
// in bytes, whole: rows past the tensor's end arrive zero-filled.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma's descriptor of a tile of 128-byte rows in the 128-byte swizzle:
// start address, leading and stride byte offsets (in 16-byte units).
// K-major (Q, K): 8-row groups 1024 bytes apart (SBO), LBO unused; a step
// of 16 along dh is 32 bytes further inside the swizzled row. MN-major
// (V): 8-key groups 1024 bytes apart (SBO), the next 64 of dh one box
// further (LBO). Every tile starts 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Named barriers over the two consumer warpgroups (256 threads): sync
// waits for the other warpgroup's arrive; barrier 0 is __syncthreads'.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product (between issue and wait).
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

#define WG_OUT8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_OUT32(d, i) WG_OUT8(d, i), WG_OUT8(d, i + 8), WG_OUT8(d, i + 16), WG_OUT8(d, i + 24)
#define WG_REGS32                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31"
#define WG_REGS64 WG_REGS32                                                  \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
  "%60, %61, %62, %63"

// D (64 x N, f32) = [D +] A B over k16, bf16 operands. ss: A and B from
// shared memory, both K-major (D = D + A B unless !acc). rs: A from
// registers (the m16n8k16 A fragment of each warp's 16 rows), B MN-major
// (transpose bit set), always accumulating.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32 "},"
                 " %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : WG_OUT32(d, 0) : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32 "},"
                 " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : WG_OUT32(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS64 "},"
                 " %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : WG_OUT32(d, 0), WG_OUT32(d, 32) : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS64 "},"
                 " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                 : WG_OUT32(d, 0), WG_OUT32(d, 32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Shared memory: Q (kWgBq rows), then kStages K tiles, kStages V tiles,
// each as DQK / 64 (K) or DV / 64 (V) boxes of rows x 128 bytes; then the
// mbarriers. kStages is ring_stages of the widths.
template <int DQK, int DV>
struct WgSmem {
  static constexpr int kQBox = kWgBq * kSwz * 2;   // bytes of one 64-wide box of Q
  static constexpr int kKVBox = kWgBk * kSwz * 2;  // ... of K or V
  static constexpr int kQ = kQBox * (DQK / kSwz);
  static constexpr int kK = kKVBox * (DQK / kSwz);  // one K tile
  static constexpr int kV = kKVBox * (DV / kSwz);   // one V tile
  static constexpr int kStages = ring_stages(kQ, kK + kV);
  static constexpr int kBars = kQ + kStages * (kK + kV);
  // 1024 bytes of room to align the start, and 1 + 2 * kStages mbarriers
  static constexpr int kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= kSmemMax, "more shared memory than a block may have");
  static_assert(DQK % kSwz == 0 && DV % kSwz == 0 && DV <= DQK,
                "widths in whole 64-wide boxes, v no wider than q and k");
};

// Accumulator layout of wgmma m64nNk16 (f32), lane = 4 * g + t of warp w
// of the warpgroup: d[4j + 0..1] at row 16w + g, columns 8j + 2t and
// 8j + 2t + 1; d[4j + 2..3] the same columns of row 16w + g + 8. Packed to
// bf16 pairs, d[8kk .. 8kk + 7] of S are the A fragment of k16 step kk of
// P V, so P never leaves the registers.
template <int DQK, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ o, int S, int T, int H, int KV,
                float scale_log2, int causal) {
  using L = WgSmem<DQK, DV>;
  constexpr int kRing = L::kStages;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t sQ = (smem_u32(wg_smem) + 1023) & ~1023u;  // the swizzle's alignment
  const uint32_t sK = sQ + L::kQ;
  const uint32_t sV = sK + kRing * L::kK;
  const uint32_t q_full = sQ + L::kBars;
  const uint32_t full0 = q_full + 8;               // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kRing;       // empty[s] = empty0 + 8 s

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBq;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_kt = key_tiles(q0, kWgBq, S, T, kWgBk, causal);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = h / (H / KV);
      mbar_expect_tx(q_full, L::kQ);
      for (int x = 0; x < DQK / kSwz; ++x)
        tma_load(sQ + x * L::kQBox, &q_map, q_full, x * kSwz, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kRing;
        mbar_wait(empty0 + 8 * s, ((kt / kRing) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full0 + 8 * s, L::kK + L::kV);
        for (int x = 0; x < DQK / kSwz; ++x) {  // V's DV / 64 boxes beside K's first ones
          tma_load(sK + s * L::kK + x * L::kKVBox, &k_map, full0 + 8 * s, x * kSwz, kvh,
                   kt * kWgBk, b);
          if (x < DV / kSwz)
            tma_load(sV + s * L::kV + x * L::kKVBox, &v_map, full0 + 8 * s, x * kSwz, kvh,
                     kt * kWgBk, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows 64 (wg - 1) .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wq0 = q0 + 64 * (wg - 1);
    const int row0 = wq0 + 16 * warp + g, row1 = row0 + 8;
    const uint64_t q_desc = smem_desc(sQ + 64 * (wg - 1) * 128, 16, 1024);

    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    float sc[kWgBk / 2];         // S of one tile, then its p
    uint32_t pa[kWgBk / 16][4];  // p in bf16: the A fragments of P V

    // S = Q K^T of the tile in slot s, issued: step kk of dqk is in box
    // kk / 4, 32 bytes per step within it
    auto issue_qk = [&](int s) {
      const uint64_t k_desc = smem_desc(sK + s * L::kK, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t qo = ((kk / 4) * L::kQBox + (kk % 4) * 32) >> 4;
        const uint32_t ko = ((kk / 4) * L::kKVBox + (kk % 4) * 32) >> 4;
        Wgmma<kWgBk>::ss(sc, q_desc + qo, k_desc + ko, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in slot s, issued: step kk takes keys 16 kk ..
    // 16 kk + 15, 16 rows of V further
    auto issue_pv = [&](int s) {
      const uint64_t v_desc = smem_desc(sV + s * L::kV, L::kKVBox, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBk / 16; ++kk)
        Wgmma<DV>::rs(acc, pa[kk], v_desc + ((kk * 16 * 128) >> 4));
      wgmma_commit();
    };
    // The online softmax of tile kt on sc: the mask (on edge tiles only),
    // the running max and sum, and p in place of the scores. Returns the
    // factors that rescale acc to the new running max.
    auto softmax = [&](int kt) {
      const int k0 = kt * kWgBk;
      const bool edge_tile = k0 + kWgBk > T || (causal && k0 + kWgBk - 1 > wq0);
      float rmax0 = kNegInf, rmax1 = kNegInf;
      if (edge_tile) {
#pragma unroll
        for (int j = 0; j < kWgBk / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e] * scale_log2;
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = e < 2 ? row0 : row1;
            if (key >= T || (causal && key > qpos)) x = kNegInf;
            sc[4 * j + e] = x;
            if (e < 2) rmax0 = fmaxf(rmax0, x); else rmax1 = fmaxf(rmax1, x);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kWgBk / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = sc[4 * j + e] * scale_log2;
            sc[4 * j + e] = x;
            if (e < 2) rmax0 = fmaxf(rmax0, x); else rmax1 = fmaxf(rmax1, x);
          }
        }
      }
      rmax0 = fmaxf(rmax0, __shfl_xor_sync(0xffffffffu, rmax0, 1));
      rmax0 = fmaxf(rmax0, __shfl_xor_sync(0xffffffffu, rmax0, 2));
      rmax1 = fmaxf(rmax1, __shfl_xor_sync(0xffffffffu, rmax1, 1));
      rmax1 = fmaxf(rmax1, __shfl_xor_sync(0xffffffffu, rmax1, 2));
      const float new0 = fmaxf(m0, rmax0), new1 = fmaxf(m1, rmax1);
      const float corr0 = exp2f(m0 - new0), corr1 = exp2f(m1 - new1);
      m0 = new0;
      m1 = new1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kWgBk / 8; ++j) {
        sc[4 * j + 0] = exp2f(sc[4 * j + 0] - new0);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - new0);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - new1);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - new1);
        sum0 += sc[4 * j + 0] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
      return make_float2(corr0, corr1);
    };
    // acc to the new running max: between the products that write it
    auto rescale = [&](float2 corr) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        acc[4 * j + 0] *= corr.x;
        acc[4 * j + 1] *= corr.x;
        acc[4 * j + 2] *= corr.y;
        acc[4 * j + 3] *= corr.y;
      }
    };
    // p, rounded to bf16, into pa: once the P V product reading pa is done
    auto pack = [&] {
#pragma unroll
      for (int kk = 0; kk < kWgBk / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    auto release = [&](int s) {  // this warp is done with slot s
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    };

    // The two consumer warpgroups take turns to issue their products
    // (named barriers 1 and 2, the first turn warpgroup 1's), so that one's
    // softmax runs under the other's products. A turn issues tile kt's
    // S = Q K^T and tile kt - 1's P V, with acc rescaled between the two;
    // tile kt's softmax starts under that P V (ptxas puts the wait for it
    // after the mask and the row max, before the exponentials). The
    // operations on acc, and so its rounding, are those of
    // acc = acc * corr_kt + P_kt V_kt.
    const int me = wg - 1;
    auto my_turn = [&] { named_sync(1 + me); };
    auto their_turn = [&] { named_arrive(2 - me); };
    if (me == 1) their_turn();
    mbar_wait(q_full, 0);
    mbar_wait(full0, 0);
    my_turn();
    issue_qk(0);
    their_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    float2 corr = softmax(0);
    pack();
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % kRing, prev = (kt - 1) % kRing;
      mbar_wait(full0 + 8 * s, (kt / kRing) & 1);
      my_turn();
      issue_qk(s);
      rescale(corr);
      issue_pv(prev);
      their_turn();
      wgmma_wait<1>();  // S of tile kt (committed first) has completed
      fence_regs(sc);
      corr = softmax(kt);
      wgmma_wait<0>();  // and P V of tile kt - 1
      fence_regs(acc);
      fence_regs(pa);  // live to here: its registers are not reused under P V
      release(prev);
      pack();
    }
    my_turn();
    rescale(corr);
    issue_pv((n_kt - 1) % kRing);
    if (me == 0) their_turn();  // each warpgroup has as many turns as it is given
    wgmma_wait<0>();
    fence_regs(acc);
    release((n_kt - 1) % kRing);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const long long o_stride = static_cast<long long>(H) * DV;
    __nv_bfloat16* ob = o + (static_cast<long long>(b) * S * H + h) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(ob + row0 * o_stride + col) =
            pack_bf16(acc[4 * j + 0] / d0, acc[4 * j + 1] / d0);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(ob + row1 * o_stride + col) =
            pack_bf16(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
  }
}

// ------------------------------------------------------------ f32, FMA
constexpr int kFq = 32;  // query rows per CTA
constexpr int kFk = 32;  // keys per tile (= warp width: one lane per key)
constexpr int kFThreads = 256;

// One 32-row query tile of the f32 kernel; its kernels below differ only
// in their launch bounds.
template <int DQK, int DV>
__device__ __forceinline__ void f32_attend(const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           float* __restrict__ o, int S, int T, int H,
                                           int KV, float scale_log2, int causal) {
  constexpr int QS = DQK + 1;  // padded: lanes reading one column hit distinct banks
  constexpr int PS = kFk + 1;
  constexpr int PER = DV / 8;  // output columns per thread
  extern __shared__ float fsm[];
  float* Qs = fsm;               // [kFq][QS]
  float* Ks = Qs + kFq * QS;     // [kFk][QS]
  float* Vs = Ks + kFk * QS;     // [kFk][DV]
  float* Ps = Vs + kFk * DV;     // [kFq][PS]: scores, then probabilities
  float* ms = Ps + kFq * PS;     // running max per row
  float* ls = ms + kFq;          // running denominator per row
  float* cs = ls + kFq;          // this tile's correction per row

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  const long long q_stride = static_cast<long long>(H) * DQK;
  const long long k_stride = static_cast<long long>(KV) * DQK;
  const long long v_stride = static_cast<long long>(KV) * DV;
  const float* qb = q + (static_cast<long long>(b) * S * H + h) * DQK;
  const float* kb = k + (static_cast<long long>(b) * T * KV + kvh) * DQK;
  const float* vb = v + (static_cast<long long>(b) * T * KV + kvh) * DV;

  for (int i = tid; i < kFq * DQK; i += blockDim.x) {
    const int r = i / DQK, d = i % DQK;
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
    for (int i = tid; i < kFk * DQK; i += blockDim.x) {  // DV <= DQK
      const int r = i / DQK, d = i % DQK;
      const bool in = k0 + r < T;
      Ks[r * QS + d] = in ? kb[(k0 + r) * k_stride + d] : 0.f;
      if (DV == DQK || d < DV) Vs[r * DV + d] = in ? vb[(k0 + r) * v_stride + d] : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < kFq * kFk; i += blockDim.x) {
      const int r = i / kFk, c = i % kFk;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DQK; ++d) dot = fmaf(Qs[r * QS + d], Ks[c * QS + d], dot);
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
      for (int j = 0; j < PER; ++j) acc[j] = fmaf(p, Vs[kc * DV + pd + 8 * j], acc[j]);
    }
  }
  __syncthreads();
  if (q0 + pr < S) {
    const float den = fmaxf(ls[pr], 1e-30f);
    const long long o_stride = static_cast<long long>(H) * DV;
    float* orow = o + (static_cast<long long>(b) * S * H + h) * DV + (q0 + pr) * o_stride;
#pragma unroll
    for (int j = 0; j < PER; ++j) orow[pd + 8 * j] = acc[j] / den;
  }
}

// Equal widths: bounded by the threads alone, ptxas chooses the registers.
template <int DH>
__global__ void __launch_bounds__(kFThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S, int T,
              int H, int KV, float scale_log2, int causal) {
  f32_attend<DH, DH>(q, k, v, o, S, T, H, KV, scale_log2, causal);
}

// MLA's (192, 128): left to itself ptxas spills here, so this kernel asks
// for 4 blocks an SM, which leaves each thread 64 registers.
__global__ void __launch_bounds__(kFThreads, 4)
flash_fwd_f32_mla(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S, int T,
                  int H, int KV, float scale_log2, int causal) {
  f32_attend<192, 128>(q, k, v, o, S, T, H, KV, scale_log2, causal);
}

template <int DH, int DV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KV, float scale_log2,
                        int causal, cudaStream_t stream) {
  static_assert(DH == DV, "the mma.sync kernel takes one width for q, k and v");
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

template <int DQK, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int T, int H, int KV, float scale_log2,
                       int causal, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kFq + kFk) * (DQK + 1) +
                       static_cast<size_t>(kFk) * DV +
                       static_cast<size_t>(kFq) * (kFk + 1) + 3 * kFq) *
                      sizeof(float);
  static_assert(DQK == DV || (DQK == 192 && DV == 128), "no f32 kernel for these widths");
  auto kern = flash_fwd_f32_mla;
  if constexpr (DQK == DV) kern = flash_fwd_f32<DQK>;
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

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled is a driver-API function: found through the
// runtime, so the library needs no link against libcuda.
cudaError_t encode_tiled(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// x (batch, rows, heads, dh) in bf16 as the 4-D tensor (dh, heads, rows,
// batch), innermost first, in boxes of (64, 1, box_rows, 1) with the
// 128-byte swizzle; rows past the end are zero-filled.
int tensor_map(EncodeTiled encode, CUtensorMap* map, const void* x, int dh, int heads,
               int rows, int batch, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(heads) * dh * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(dh) * 2, row_bytes, rows * row_bytes};
  const cuuint32_t box[4] = {kSwz, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaEncodeFailed + static_cast<int>(r);
}

template <int DQK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S, int T,
                 int H, int KV, float scale_log2, int causal, cudaStream_t stream) {
  EncodeTiled encode;
  int err = encode_tiled(&encode);
  if (err != 0) return err;
  CUtensorMap q_map, k_map, v_map;
  if ((err = tensor_map(encode, &q_map, q, DQK, H, S, B, kWgBq)) != 0) return err;
  if ((err = tensor_map(encode, &k_map, k, DQK, KV, T, B, kWgBk)) != 0) return err;
  if ((err = tensor_map(encode, &v_map, v, DV, KV, T, B, kWgBk)) != 0) return err;
  constexpr int smem = WgSmem<DQK, DV>::kBytes;
  auto kern = flash_fwd_wgmma<DQK, DV>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kWgBq - 1) / kWgBq, H, B);
  kern<<<grid, kWgThreads, smem, stream>>>(q_map, k_map, v_map,
                                           static_cast<__nv_bfloat16*>(o), S, T, H, KV,
                                           scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, dqk), k (B, T, KV, dqk), v (B, T, KV, dv), o (B, S, H, dv),
// all contiguous and 16-byte aligned. dtype: 0 = bfloat16, 1 = float32
// (shared by all four). scale multiplies the scores (dqk ** -0.5 by
// default, chosen by the caller). The route is chosen by dtype and
// (dqk, dv), one ROUTE line each: bf16 at (64, 64), (128, 128) and
// (192, 128) runs the wgmma kernel, bf16 at (16, 16) and (32, 32) the
// mma.sync kernel, float32 the FMA kernel. Any other pair is refused with
// cudaErrorInvalidValue.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KV, int dqk, int dv, int dtype,
                        float scale, int causal, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ROUTE(DTYPE, DQK, DV, launch)                                            \
  if (dtype == DTYPE && dqk == DQK && dv == DV)                                  \
    return launch<DQK, DV>(q, k, v, o, B, S, T, H, KV, scale_log2, causal, st);
  ROUTE(0, 16, 16, launch_bf16)
  ROUTE(0, 32, 32, launch_bf16)
  ROUTE(0, 64, 64, launch_wgmma)
  ROUTE(0, 128, 128, launch_wgmma)
  ROUTE(0, 192, 128, launch_wgmma)
  ROUTE(1, 16, 16, launch_f32)
  ROUTE(1, 32, 32, launch_f32)
  ROUTE(1, 64, 64, launch_f32)
  ROUTE(1, 128, 128, launch_f32)
  ROUTE(1, 192, 128, launch_f32)
#undef ROUTE
  return cudaErrorInvalidValue;
}

const char* flash_error_string(int code) {
  if (code >= kTmaEncodeFailed) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             code - kTmaEncodeFailed);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
