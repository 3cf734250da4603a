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
// element.
//
// What bounds it: the output written once and idx/ts read once,
// 4 * M * E + 8 * M * C bytes over 3.35 TB/s; the work is one compare per
// slot per tile and one max per finite slot, far under one operation per
// byte, so the kernel is bound by writing the output. The design is for
// the write:
//   * a persistent grid (as many blocks as fit on the card at once) walks
//     the (row, kTile-column tile) work items, so no block is short-lived
//     and every block keeps writing;
//   * each item folds its row's C slots into a shared-memory tile with an
//     exact float32 atomic max (atomicMax on the int bits when the value's
//     sign bit is clear, atomicMin on the unsigned bits when it is set, the
//     trick kernel B5 uses in global memory): no global atomics, no
//     separate fill pass, and every output element is written once;
//   * the tile goes out in 16-byte stores, and each thread puts -inf back
//     into the shared words it has just read, so the next item starts from
//     a clean tile without a fill pass of its own: two barriers per item;
//   * row m starts at m * E floats, 16-byte aligned only when E % 4 == 0.
//     The tile is therefore shifted in shared memory by the misalignment r
//     of its first output column (0..3 floats): shared word w holds column
//     w - r, and shared float4 q goes to the 16-byte aligned address of
//     column 4q - r. The one float4 that straddles the tile's start and the
//     one that straddles its end are stored lane by lane; all others whole.
// Max is order-independent, so the result is bit-identical to the plain
// version however the atomics interleave.
//
// Numerics: keys outside [0, E) are dropped, as JAX's scatter drops
// out-of-range updates. Timestamps hold no NaN. Built without
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;             // output columns per work item
constexpr int kSmemVec = kTile / 4 + 1; // float4 words: the tile plus the shift r

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

__global__ void __launch_bounds__(kThreads)
rowsparse_gather_kernel(const int* __restrict__ idx, const float* __restrict__ ts,
                        float* __restrict__ out, int C, int E, int tiles, int64_t items) {
  __shared__ float4 tile4[kSmemVec];
  float* tile = reinterpret_cast<float*>(tile4);
  const float4 ninf4 = make_float4(neg_inf(), neg_inf(), neg_inf(), neg_inf());
  for (int q = threadIdx.x; q < kSmemVec; q += kThreads) tile4[q] = ninf4;

  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t m = item / tiles;
    const int col0 = static_cast<int>(item - m * tiles) * kTile;
    const int width = min(kTile, E - col0);
    float* dst = out + m * static_cast<int64_t>(E) + col0;
    const int r = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3u);
    __syncthreads();   // the tile is all -inf: the last write-out reset it
    const int* idx_row = idx + m * C;
    const float* ts_row = ts + m * C;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float v = __ldg(ts_row + c);
      if (v == neg_inf()) continue;                      // a free slot
      const int key = __ldg(idx_row + c) - col0;
      if (static_cast<unsigned>(key) >= static_cast<unsigned>(width)) continue;
      atomic_max_f32(tile + key + r, v);
    }
    __syncthreads();
    float4* dst4 = reinterpret_cast<float4*>(dst - r);   // 16-byte aligned
    const int nq = (width + r + 3) >> 2;
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const float4 v = tile4[q];
      tile4[q] = ninf4;
      const int c0 = 4 * q - r;                          // column of v.x
      if (c0 >= 0 && c0 + 4 <= width) {
        dst4[q] = v;
      } else {                                           // the tile's edges
        const float lanes[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int l = 0; l < 4; ++l)
          if (c0 + l >= 0 && c0 + l < width) dst[c0 + l] = lanes[l];
      }
    }
  }
}

}  // namespace

extern "C" int rowsparse_gather_f32(const int* idx, const float* ts, float* out,
                                    int M, int C, int E, void* stream) {
  if (M < 1 || C < 0 || E < 1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) & 3u) return (int)cudaErrorInvalidValue;
  static int grid_cap = 0;   // resident blocks on the card, found once
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rowsparse_gather_kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = (E + kTile - 1) / kTile;
  const int64_t items = static_cast<int64_t>(M) * tiles;
  const int grid = static_cast<int>(items < grid_cap ? items : grid_cap);
  rowsparse_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, ts, out, C, E, tiles, items);
  return (int)cudaGetLastError();
}
