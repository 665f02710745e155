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
// Design: one CTA per row. The row (keys, and values for the kv kernels)
// sits in dynamic shared memory: 8192 keys + 8192 values = 64 KB, above
// the 48 KB default, hence cudaFuncSetAttribute before each launch. Every
// stage is one pass of the block's threads over the row's N/2 pairs,
// followed by __syncthreads().
//
// Bound on the card: each kernel must read its row bytes once and write
// them once. For n = 2^22 float32 keys one pass is 32 MiB, about 10 us at
// 3.35 TB/s (20 us with int32 values). The network's k(k+1)/2 stages run
// out of shared memory, so device memory sees the row only twice.
//
// Types: keys and values are int32 (code 0), uint32 (code 1) or float32
// (code 2). Narrower types are widened by the Python wrapper. Every entry
// point returns the cudaError_t of its launch (0 = success) and never
// synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRow = 8192;
constexpr int kMaxThreads = 512;

// One compare-exchange stage at distance j = 2^sub over a row of 2*half
// elements in shared memory. Pair q sits at lo = block*2j + (q mod j).
template <typename K, typename V, bool HAS_V>
__device__ __forceinline__ void cmpx_stage(K* sk, V* sv, int half, int sub,
                                           int span, bool tiebreak) {
  const int j = 1 << sub;
  for (int q = threadIdx.x; q < half; q += blockDim.x) {
    const int lo = ((q >> sub) << (sub + 1)) | (q & (j - 1));
    const int hi = lo + j;
    // span is a power of two >= 2j, so lo / span == block_start / span
    const bool asc = (lo & span) == 0;
    const K a = sk[lo];
    const K b = sk[hi];
    bool gt = a > b;
    bool lt = a < b;
    if (HAS_V && tiebreak) {
      const bool eq = a == b;
      const V va = sv[lo];
      const V vb = sv[hi];
      gt = gt || (eq && va > vb);
      lt = lt || (eq && va < vb);
    }
    if (asc ? gt : lt) {
      sk[lo] = b;
      sk[hi] = a;
      if (HAS_V) {
        const V t = sv[lo];
        sv[lo] = sv[hi];
        sv[hi] = t;
      }
    }
  }
}

// Full bitonic sort network, ascending: for s in 0..k-1, span 2^(s+1),
// distances 2^s down to 1 (repro/kernels/bitonic.py::_sort_network).
template <typename K, typename V, bool HAS_V>
__global__ void sort_rows_kernel(const K* __restrict__ kin,
                                 const V* __restrict__ vin,
                                 K* __restrict__ kout, V* __restrict__ vout,
                                 int n, int log_n, bool tiebreak) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  V* sv = reinterpret_cast<V*>(smem + static_cast<size_t>(n) * sizeof(K));
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sk[i] = kin[base + i];
    if (HAS_V) sv[i] = vin[base + i];
  }
  __syncthreads();
  const int half = n >> 1;
  for (int s = 0; s < log_n; ++s) {
    const int span = 2 << s;
    for (int sub = s; sub >= 0; --sub) {
      cmpx_stage<K, V, HAS_V>(sk, sv, half, sub, span, tiebreak);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    kout[base + i] = sk[i];
    if (HAS_V) vout[base + i] = sv[i];
  }
}

// Merge of two sorted rows of n: a ++ reverse(b) is bitonic, then the
// half-cleaner stages at distances n .. 1 under one ascending span of 2n
// (repro/kernels/bitonic.py::_merge_network).
template <typename K, typename V, bool HAS_V>
__global__ void merge_rows_kernel(const K* __restrict__ ak,
                                  const V* __restrict__ av,
                                  const K* __restrict__ bk,
                                  const V* __restrict__ bv,
                                  K* __restrict__ kout, V* __restrict__ vout,
                                  int n, int log_n2, bool tiebreak) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n2 = 2 * n;
  K* sk = reinterpret_cast<K*>(smem);
  V* sv = reinterpret_cast<V*>(smem + static_cast<size_t>(n2) * sizeof(K));
  const size_t in_base = static_cast<size_t>(blockIdx.x) * n;
  const size_t out_base = static_cast<size_t>(blockIdx.x) * n2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sk[i] = ak[in_base + i];
    sk[n + i] = bk[in_base + (n - 1 - i)];
    if (HAS_V) {
      sv[i] = av[in_base + i];
      sv[n + i] = bv[in_base + (n - 1 - i)];
    }
  }
  __syncthreads();
  for (int sub = log_n2 - 1; sub >= 0; --sub) {
    cmpx_stage<K, V, HAS_V>(sk, sv, n, sub, n2, tiebreak);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    kout[out_base + i] = sk[i];
    if (HAS_V) vout[out_base + i] = sv[i];
  }
}

int ilog2(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

bool bad_shape(long long rows, int n) {
  return rows <= 0 || rows > 0x7fffffffLL || n < 2 || n > kMaxRow ||
         (n & (n - 1)) != 0;
}

template <typename K, typename V, bool HAS_V>
cudaError_t launch_sort(const void* k, const void* v, void* ok, void* ov,
                        long long rows, int n, bool tiebreak,
                        cudaStream_t stream) {
  if (bad_shape(rows, n)) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(n) * (sizeof(K) + (HAS_V ? sizeof(V) : 0));
  auto kern = sort_rows_kernel<K, V, HAS_V>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = (n / 2) < kMaxThreads ? (n / 2) : kMaxThreads;
  kern<<<static_cast<unsigned>(rows), threads, smem, stream>>>(
      static_cast<const K*>(k), static_cast<const V*>(v), static_cast<K*>(ok),
      static_cast<V*>(ov), n, ilog2(n), tiebreak);
  return cudaGetLastError();
}

template <typename K, typename V, bool HAS_V>
cudaError_t launch_merge(const void* ak, const void* av, const void* bk,
                         const void* bv, void* ok, void* ov, long long rows,
                         int n, bool tiebreak, cudaStream_t stream) {
  if (bad_shape(rows, 2 * n)) return cudaErrorInvalidValue;
  const int n2 = 2 * n;
  const size_t smem = static_cast<size_t>(n2) * (sizeof(K) + (HAS_V ? sizeof(V) : 0));
  auto kern = merge_rows_kernel<K, V, HAS_V>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = n < kMaxThreads ? n : kMaxThreads;
  kern<<<static_cast<unsigned>(rows), threads, smem, stream>>>(
      static_cast<const K*>(ak), static_cast<const V*>(av),
      static_cast<const K*>(bk), static_cast<const V*>(bv),
      static_cast<K*>(ok), static_cast<V*>(ov), n, ilog2(n2), tiebreak);
  return cudaGetLastError();
}

// Type codes shared with repro_torch/kernels/bitonic.py::_TYPE_CODES.
#define DISPATCH_TYPE(code, T, ...)         \
  switch (code) {                           \
    case 0: { using T = int32_t; __VA_ARGS__ } \
    case 1: { using T = uint32_t; __VA_ARGS__ } \
    case 2: { using T = float; __VA_ARGS__ }   \
    default: return cudaErrorInvalidValue;  \
  }

}  // namespace

extern "C" {

int bitonic_sort_rows(const void* keys, void* out, long long rows, int n,
                      int key_type, void* stream) {
  DISPATCH_TYPE(key_type, K,
    return launch_sort<K, K, false>(keys, nullptr, out, nullptr, rows, n,
                                    false, static_cast<cudaStream_t>(stream));)
}

int bitonic_sort_rows_kv(const void* keys, const void* values, void* out_keys,
                         void* out_values, long long rows, int n, int key_type,
                         int value_type, int stable, void* stream) {
  DISPATCH_TYPE(key_type, K,
    DISPATCH_TYPE(value_type, V,
      return launch_sort<K, V, true>(keys, values, out_keys, out_values, rows,
                                     n, stable != 0,
                                     static_cast<cudaStream_t>(stream));))
}

int bitonic_merge_rows(const void* a, const void* b, void* out, long long rows,
                       int n, int key_type, void* stream) {
  DISPATCH_TYPE(key_type, K,
    return launch_merge<K, K, false>(a, nullptr, b, nullptr, out, nullptr,
                                     rows, n, false,
                                     static_cast<cudaStream_t>(stream));)
}

int bitonic_merge_rows_kv(const void* ak, const void* av, const void* bk,
                          const void* bv, void* out_keys, void* out_values,
                          long long rows, int n, int key_type, int value_type,
                          int stable, void* stream) {
  DISPATCH_TYPE(key_type, K,
    DISPATCH_TYPE(value_type, V,
      return launch_merge<K, V, true>(ak, av, bk, bv, out_keys, out_values,
                                      rows, n, stable != 0,
                                      static_cast<cudaStream_t>(stream));))
}

const char* bitonic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
