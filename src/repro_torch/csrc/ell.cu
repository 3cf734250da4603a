// Kernel B5: ELL gather-contract (bottleneck semiring) on Hopper.
//
//     out[j, m, v] = max over (u, e) with idx[j, u, e] == v of
//                    min(d[j, m, u], ts[j, u, e])
//
// d (J, M, U) float32, idx (J, U, E) int32, ts (J, U, E) float32, out
// (J, M, U) float32, all row-major and contiguous. -inf is the semiring
// zero: the wrapper fills `out` with -inf before the launch, free ELL slots
// carry ts == -inf, and a -inf candidate is never written. A second entry,
// `ell_gather_contract_s32`, runs the same kernel on the bucket backend's
// int32 levels (d, ts and out int32), whose zero is level 0: the wrapper
// fills 0, free slots carry level 0, the fold is a plain integer atomicMax.
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

// The semiring zero of each lattice: -inf on float32 timestamps, level 0
// on the bucket backend's int32 levels.
__device__ __forceinline__ float zero_of(float) { return __int_as_float(0xff800000); }
__device__ __forceinline__ int zero_of(int) { return 0; }

__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ int min_of(int a, int b) { return min(a, b); }

// Exact float32 max into *addr (no NaN): see the header comment.
__device__ __forceinline__ void atomic_max_to(float* addr, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_max_to(int* addr, int v) { atomicMax(addr, v); }

// grid.x covers U in blocks of kThreads; grid.y strides over the J * M
// rows of d and out. A candidate at or below the zero cannot raise an
// output the wrapper filled with the zero, so it is skipped.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_gather_contract_kernel(const T* __restrict__ d, const int* __restrict__ idx,
                           const T* __restrict__ ts, T* __restrict__ out,
                           int J, int M, int U, int E) {
  const int u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= U) return;
  const T zero = zero_of(T());
  const int64_t rows = (int64_t)J * M;
  for (int64_t jm = blockIdx.y; jm < rows; jm += gridDim.y) {
    const T dv = __ldg(d + jm * U + u);
    if (dv <= zero) continue;
    const int64_t slot0 = ((jm / M) * U + u) * (int64_t)E;
    T* out_row = out + jm * U;
    for (int e = 0; e < E; ++e) {
      const T c = min_of(dv, __ldg(ts + slot0 + e));
      if (c <= zero) continue;
      const int v = __ldg(idx + slot0 + e);
      if (v < 0 || v >= U) continue;  // out of range: dropped, as JAX's scatter
      atomic_max_to(out_row + v, c);
    }
  }
}

template <typename T>
int launch(const T* d, const int* idx, const T* ts, T* out, int J, int M, int U, int E,
           void* stream) {
  if (J < 1 || M < 1 || U < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)J * M;
  const dim3 grid((U + kThreads - 1) / kThreads,
                  (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  ell_gather_contract_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d, idx, ts, out, J, M, U, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ell_gather_contract_f32(const float* d, const int* idx, const float* ts,
                                       float* out, int J, int M, int U, int E,
                                       void* stream) {
  return launch<float>(d, idx, ts, out, J, M, U, E, stream);
}

// The bucket backend's int32 levels (zero 0): plain integer atomicMax.
extern "C" int ell_gather_contract_s32(const int* d, const int* idx, const int* ts,
                                       int* out, int J, int M, int U, int E, void* stream) {
  return launch<int>(d, idx, ts, out, J, M, U, E, stream);
}
