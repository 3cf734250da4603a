// Kernel B6: the row-sparse dist gather on Hopper.
//
//     out[m, e] = max over slots c with idx[m, c] == e of ts[m, c]
//                 (-inf where no slot holds e)
//
// idx (M, C) int32, ts (M, C) float32, out (M, E) float32, all row-major
// and contiguous. M is the gathered frontier rows (Q * F), C the per-row
// slot capacity `dist_cap` (a power of 2, a few to a few hundred) and
// E = N * K the dense row width (32768 at N = 8192, K = 4). -inf is the
// semiring zero: a free slot carries ts == -inf (and a stale idx) and is
// skipped.
//
// Replaces `_rs_kernel` / `rowsparse_gather_fused`
// (repro/kernels/rowsparse/rowsparse.py:40-88), the Pallas TPU kernel
// that sweeps the C slots of a row block with one compare-select of the
// whole (bm, bn) output tile per slot: C compare-selects per output
// element. Here each block owns one row m and one tile of kTile output
// columns: it fills the tile with -inf in shared memory, its threads
// stride over the row's C slots and fold each finite slot whose key falls
// in the tile with an exact float32 atomic max in shared memory (atomicMax
// on the int bits when the value's sign bit is clear, atomicMin on the
// unsigned bits when it is set, the trick kernel B5 uses in global
// memory), then the block writes the tile out coalesced. Every output
// element is written once, by its block, with no separate fill pass and no
// global atomics. Max is order-independent, so the result is bit-identical
// to the plain version however the atomics interleave.
//
// What bounds it: the output written once and idx/ts read once,
// 4 * M * E + 8 * M * C bytes over 3.35 TB/s; the work is one compare per
// slot per tile and one max per finite slot, far under one operation per
// byte, so the bound is the memory traffic. Each block re-reads its row's
// C slots (E / kTile times per row; C is small and they stay in L1/L2).
//
// Numerics: keys outside [0, E) are dropped, as JAX's scatter drops
// out-of-range updates. Timestamps hold no NaN. Built without
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // output columns per block: 8 KB of shared memory
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Exact float32 max into *addr (no NaN): see the header comment.
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// grid.x = M rows, grid.y = ceil(E / kTile) column tiles.
__global__ void __launch_bounds__(kThreads)
rowsparse_gather_kernel(const int* __restrict__ idx, const float* __restrict__ ts,
                        float* __restrict__ out, int C, int E) {
  __shared__ float tile[kTile];
  const int64_t m = blockIdx.x;
  const int col0 = blockIdx.y * kTile;
  const int width = min(kTile, E - col0);
  for (int i = threadIdx.x; i < width; i += kThreads) tile[i] = neg_inf();
  __syncthreads();
  const int* idx_row = idx + m * C;
  const float* ts_row = ts + m * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float v = __ldg(ts_row + c);
    if (v == neg_inf()) continue;            // a free slot
    const int key = __ldg(idx_row + c);
    if (key < col0 || key >= col0 + width) continue;  // another tile's
    atomic_max_f32(tile + (key - col0), v);
  }
  __syncthreads();
  float* out_row = out + m * (int64_t)E + col0;
  for (int i = threadIdx.x; i < width; i += kThreads) out_row[i] = tile[i];
}

}  // namespace

extern "C" int rowsparse_gather_f32(const int* idx, const float* ts, float* out,
                                    int M, int C, int E, void* stream) {
  if (M < 1 || C < 0 || E < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (E + kTile - 1) / kTile;
  if (tiles > kMaxGridY) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)M, (unsigned)tiles);
  rowsparse_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, ts, out, C, E);
  return (int)cudaGetLastError();
}
