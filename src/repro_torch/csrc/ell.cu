// Kernel B5: ELL gather-contract (bottleneck semiring) on Hopper.
//
//     out[j, m, v] = max over (u, e) with idx[j, u, e] == v of
//                    min(d[j, m, u], ts[j, u, e])
//
// d (J, M, U) float32, idx (J, U, E) int32, ts (J, U, E) float32, out
// (J, M, U) float32, all row-major and contiguous. -inf is the semiring
// zero: the wrapper fills `out` with -inf before the launch, free ELL slots
// carry ts == -inf, and a -inf candidate is never written.
//
// Replaces `_ell_kernel` / `ell_gather_contract_fused`
// (repro/kernels/ell/ell.py:39-97), the Pallas TPU kernel that contracts a
// row block of dist against padded-ELL adjacency rows by walking the slots
// in series with a whole-row output block. On this card blocks run in
// parallel and in no order, so the contraction is written as a scatter:
// each thread takes one (j, m, u), reads d[j, m, u] (coalesced along u),
// drops out at once when it is -inf (most dist rows are mostly -inf),
// else walks the E slots of row u and folds each finite candidate into
// out[j, m, idx[j, u, e]] with an atomic max that is exact for float32:
// atomicMax on the int bits when the candidate's sign bit is clear,
// atomicMin on the unsigned bits when it is set (negative floats order in
// reverse as unsigned ints; -inf starts below every candidate). Max is
// order-independent, so the result is bit-identical to the plain version
// in any launch order.
//
// What bounds it: each input is read once and the output written once,
// 4 * (J*M*U + J*M*U) + 8 * J*U*E bytes over 3.35 TB/s, against
// 2 * J*M*U*E min/max operations over 67 TFLOP/s; at E <= 8 that is under
// 2 operations per byte, so the bound is the memory traffic (and the
// atomics, which this count leaves out). Later work: a destination-major
// layout, or a shared-memory row accumulator per (j, m) block, that
// writes each output row once without global atomics.
//
// Numerics: fminf differs from jnp.minimum only on NaN inputs, and the
// engine's timestamps hold no NaN. Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

// grid.x covers U in blocks of kThreads; grid.y strides over the J * M
// rows of d and out.
__global__ void __launch_bounds__(kThreads)
ell_gather_contract_kernel(const float* __restrict__ d, const int* __restrict__ idx,
                           const float* __restrict__ ts, float* __restrict__ out,
                           int J, int M, int U, int E) {
  const int u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= U) return;
  const int64_t rows = (int64_t)J * M;
  for (int64_t jm = blockIdx.y; jm < rows; jm += gridDim.y) {
    const float dv = __ldg(d + jm * U + u);
    if (dv == neg_inf()) continue;
    const int64_t slot0 = ((jm / M) * U + u) * (int64_t)E;
    float* out_row = out + jm * U;
    for (int e = 0; e < E; ++e) {
      const float c = fminf(dv, __ldg(ts + slot0 + e));
      if (c == neg_inf()) continue;
      const int v = __ldg(idx + slot0 + e);
      if (v < 0 || v >= U) continue;  // out of range: dropped, as JAX's scatter
      atomic_max_f32(out_row + v, c);
    }
  }
}

}  // namespace

extern "C" int ell_gather_contract_f32(const float* d, const int* idx, const float* ts,
                                       float* out, int J, int M, int U, int E,
                                       void* stream) {
  if (J < 1 || M < 1 || U < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)J * M;
  const dim3 grid((U + kThreads - 1) / kThreads,
                  (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  ell_gather_contract_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d, idx, ts, out, J, M, U, E);
  return (int)cudaGetLastError();
}
