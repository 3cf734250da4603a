// Kernel B1: batched (max, min) bottleneck-semiring product on Hopper.
//
//     out[j, i, n] = max_k min(a[j, i, k], b[j, k, n])
//
// a (J, m, k), b (J, k, n), out (J, m, n), all row-major and contiguous,
// float32 or float16. -inf is the semiring zero: it fills the ragged
// edges of every tile, so any m, k, n >= 1 is exact and no padded copy of
// an input is ever made.
//
// Replaces `_maxmin_fused_kernel` (repro/kernels/maxmin/maxmin.py:138),
// the Pallas TPU kernel behind `maxmin_matmul_fused`, which the dense
// closure round calls once for all J transition rows.
//
// What bounds it: no tensor-core instruction computes max-min, so the
// product runs on the CUDA cores as one FMNMX for the min and one for the
// max per (i, n, k) triple. At the main path's shapes (J=48, m=k=n=2048)
// that is 8.2e11 min/max operations against 0.8 GB of operand and output
// bytes, about 1000 operations per byte: the kernel is bound by the
// min/max issue rate, not by memory. The tiling is shaped for that:
//   * each block stages a BM x BK tile of A and a BK x BN tile of B in
//     shared memory once per k-step, so every element loaded from device
//     memory feeds BN (or BM) compare-selects;
//   * each thread keeps a TM x TN register block of the output and, per k,
//     reads TM + TN shared-memory words for TM * TN min/max pairs, so
//     shared-memory loads stay a small share of the issued instructions;
//   * a thread's rows and columns are strided by the thread-grid extents,
//     so a warp's shared-memory reads of B hit distinct banks and its
//     output stores are coalesced.
// Left for later work: cp.async/TMA double buffering of the k tiles, and
// fusing the base term and the segment-max epilogue of the round.
//
// Numerics: fminf/fmaxf differ from jnp.minimum/jnp.maximum only on NaN
// inputs (they return the other operand), and the engine's timestamps hold
// no NaN. float16 inputs are widened to float in shared memory and the
// result narrowed back; min and max return one of their operands, so the
// round trip is exact. Built without --use_fast_math.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __half* p) { return __half2float(__ldg(p)); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__half* p, float v) { *p = __float2half_rn(v); }

// One block computes a BM x BN output tile of one batch row j; the thread
// grid is (BN / TN) columns by (BM / TM) rows of threads.
template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
maxmin_fused_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ out, int m, int k, int n) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  static_assert(TX * TY == kThreads, "thread grid must match the block size");

  // A is stored transposed (k-major) so a thread's TM rows at one k are a
  // strided read of one shared-memory row; +1 breaks the bank stride of
  // the transposing store.
  __shared__ float As[kBK][BM + 1];
  __shared__ float Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  // 64-bit batch offsets: J * m * n passes 2^31 at J=48, N=8192
  const int64_t jz = blockIdx.z;
  const T* a_j = a + jz * (int64_t)m * k;
  const T* b_j = b + jz * (int64_t)k * n;
  T* out_j = out + jz * (int64_t)m * n;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = neg_inf();

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // stage A[row0 : row0+BM, k0 : k0+BK] (k fastest: coalesced reads)
    for (int idx = tid; idx < BM * kBK; idx += kThreads) {
      const int i = idx / kBK;
      const int kk = idx % kBK;
      const int r = row0 + i;
      const int kc = k0 + kk;
      As[kk][i] = (r < m && kc < k) ? load_f(a_j + (int64_t)r * k + kc) : neg_inf();
    }
    // stage B[k0 : k0+BK, col0 : col0+BN] (n fastest: coalesced reads)
    for (int idx = tid; idx < kBK * BN; idx += kThreads) {
      const int kk = idx / BN;
      const int c = idx % BN;
      const int kc = k0 + kk;
      const int cc = col0 + c;
      Bs[kk][c] = (kc < k && cc < n) ? load_f(b_j + (int64_t)kc * n + cc) : neg_inf();
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ar[TM];
      float br[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ar[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int c = 0; c < TN; ++c) br[c] = Bs[kk][tx + c * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaxf(acc[i][c], fminf(ar[i], br[c]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= m) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int cc = col0 + tx + c * TX;
      if (cc < n) store_f(out_j + (int64_t)r * n + cc, acc[i][c]);
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN>
cudaError_t launch(const T* a, const T* b, T* out, int J, int m, int k, int n,
                   cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, J);
  maxmin_fused_kernel<T, BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(a, b, out, m, k, n);
  return cudaGetLastError();
}

// The tile table lives in repro_torch/kernels/maxmin/maxmin.py
// (`_TILE_BM`); `bm` names the entry. Unknown entries are refused.
template <typename T>
int dispatch(const T* a, const T* b, T* out, int J, int m, int k, int n, int bm,
             void* stream) {
  if (J < 1 || m < 1 || k < 1 || n < 1 || J > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 128:  // square slabs: 128 x 128 tile, 8 x 8 register block
      return (int)launch<T, 128, 128, 8, 8>(a, b, out, J, m, k, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int maxmin_fused_f32(const float* a, const float* b, float* out, int J, int m,
                                int k, int n, int bm, void* stream) {
  return dispatch<float>(a, b, out, J, m, k, n, bm, stream);
}

extern "C" int maxmin_fused_f16(const __half* a, const __half* b, __half* out, int J,
                                int m, int k, int n, int bm, void* stream) {
  return dispatch<__half>(a, b, out, J, m, k, n, bm, stream);
}
