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
// closure round calls once for all J transition rows (kernel B1), and
// `_maxmin_kernel` (maxmin.py:67), behind the single-pair `maxmin_matmul`
// that the legacy single-query round calls once per transition (kernel
// B2: the same kernels launched with J = 1 through their own entries,
// `maxmin_f32` and `maxmin_f16`).
//
// What bounds it: no tensor-core instruction computes max-min, so the
// product runs on the CUDA cores as one min and one max per (i, n, k)
// triple. On Hopper every min/max instruction (FMNMX, the integer VIMNMX
// and the three-input VIMNMX3) runs at half the FFMA rate, 64 lanes per
// clock per SM (chip_smoke.py's phase 3 measures it). On dense operands at
// the main path's shapes (J=48, m=k=n=2048) that is 8.2e11 min/max
// operations against 0.8 GB of operand and output bytes: the kernel is
// bound by that instruction rate, not by memory. On the main path itself the
// operands are the window's dist slabs and adjacency, almost all -inf: a
// k step whose A tile or B tile is all -inf leaves every accumulator as it
// was (max(acc, min(x, -inf)) = acc), and on the path about 99% of them
// are. The design does three things about that:
//   * an occupancy pre-pass (`occupancy_kernel`, one launch for both
//     operands) reads A and B once and writes one byte per (j, row tile,
//     k tile) of A and per (j, col tile, k tile) of B: does the tile hold
//     an entry other than -inf, and does it hold an "odd" value (see
//     below). The product kernel then lists, per output tile, the k tiles
//     where both of its operand tiles hold an entry, and loads and computes
//     only those. Skipping is exact: a skipped step changes nothing. On
//     dense operands the pre-pass costs one read of the inputs (about
//     0.5 ms at the path's shape) and every k tile is listed.
//   * where no listed tile of a block holds an odd value (a sign bit set on
//     anything but -inf, or NaN), the block compares the values' bits as
//     signed ints, which order as the floats do there: two integer mins
//     and one three-input max (`__vimax3_s32`) per two k, 1.5 instead of 2
//     half-rate instructions per triple. The streams' timestamps are not
//     negative, so the engine's operands take this path; negatives, -0.0
//     and NaN take the float path (fminf/fmaxf). The accumulators hold the
//     same bits on both paths.
//   * the listed k tiles stream through a ring of kStages shared-memory
//     stages filled by cp.async, so the next tiles load while this one is
//     computed, with one barrier per stage. cp.async's zero fill would be
//     wrong here (min(x, 0) = 0 > -inf), so a chunk outside the operand is
//     written as -inf by an ordinary shared-memory store instead, and 16-byte
//     copies are used only where the row stride allows them (k % 4 == 0 for
//     a, n % 4 == 0 for b, 16-byte aligned bases); other shapes take a
//     4-byte copy per element. float16 operands are widened to float while
//     staged, through registers.
// The compute is laid out for 16-byte shared-memory reads: a thread owns
// rows {4ty..4ty+3, 64+4ty..64+4ty+3} and columns {4tx..4tx+3,
// 64+4tx..64+4tx+3} of the 128 x 128 output tile; A is staged row-major
// (k fastest), so one 16-byte read gives a row's four k values, and B
// k-major, so one 16-byte read gives four columns at one k. A quarter warp
// reads one A address (a broadcast) and 128 contiguous bytes of B: no bank
// conflicts. A warp whose eight rows all lie past m (the frontier's
// skinny slabs) skips the compute.
//
// Numerics: fminf/fmaxf differ from jnp.minimum/jnp.maximum only on NaN
// inputs (they return the other operand), and the engine's timestamps hold
// no NaN. float16 inputs are widened to float in shared memory and the
// result narrowed back; min and max return one of their operands, so the
// round trip is exact. On non-negative floats and -inf, the integer min
// and max of the bits pick the operand fminf/fmaxf pick. Max and min are
// exact and order-free, so neither the order of the k tiles nor the
// skipped ones change a bit. Built without --use_fast_math.
//
// Also here, for measurement only and on no path: `minmax_rate_kernel`,
// a throughput microbenchmark of FFMA, FMNMX, the two-input integer
// min/max and the Hopper DPX three-input integer max (`__vimax3_s32`),
// which chip_smoke.py runs to read the min/max instruction rate that bounds the
// dense product.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;      // output rows per block
constexpr int kBN = 128;      // output columns per block
constexpr int kBK = 16;       // k per stage: the skip granularity
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kStageFloats = kBM * kBK + kBK * kBN;
constexpr int kSmemBytes = kStages * kStageFloats * 4;   // 48 KB, dynamic
constexpr int kMaxDevices = 64;  // devices a process configures kernels for
constexpr int kSpanTiles = 32;  // occupancy flags per pre-pass block and row tile

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __half* p) { return __half2float(__ldg(p)); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__half* p, float v) { *p = __float2half_rn(v); }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One element into shared memory: a 4-byte cp.async for float, a widening
// load and store for half; -inf outside the operand.
__device__ __forceinline__ void stage_one(float* dst, const float* src, bool in) {
  if (in) cp_async4(dst, src); else *dst = neg_inf();
}
__device__ __forceinline__ void stage_one(float* dst, const __half* src, bool in) {
  *dst = in ? load_f(src) : neg_inf();
}

// A value is "odd" when its bits do not order as a signed int the way the
// float orders: a sign bit set on anything but -inf (negatives, -0.0), or
// NaN. Non-negative floats and -inf compare as their bits do.
__device__ __forceinline__ bool odd(float v) {
  return (__float_as_int(v) < 0 && v != neg_inf()) || v != v;
}

// Occupancy flags, one byte per tile: bit 0 the tile holds an entry other
// than -inf, bit 1 it holds an odd value.
constexpr uint8_t kLive = 1;
constexpr uint8_t kOdd = 2;

// ---------------------------------------------------------------------------
// Occupancy pre-pass. One block covers TR rows and kSpanTiles tiles of TC
// columns of one j of x (J, R, C) and writes those tiles' flags. Flags are
// laid out (J, RT, CT) or, with `col_major`, (J, CT, RT), so that the
// product kernel reads a run of k tiles contiguously for both operands.
template <typename T, int TR, int TC>
__device__ void occupancy(const T* __restrict__ x, uint8_t* __restrict__ flags,
                          int R, int C, int64_t blk, bool vec, bool col_major,
                          unsigned* block_masks) {
  constexpr int kSpan = kSpanTiles * TC;
  const int RT = (R + TR - 1) / TR;
  const int CT = (C + TC - 1) / TC;
  const int spans = (CT + kSpanTiles - 1) / kSpanTiles;
  const int sp = static_cast<int>(blk % spans);
  const int64_t t = blk / spans;
  const int rt = static_cast<int>(t % RT);
  const int64_t j = t / RT;
  const int r0 = rt * TR;
  const int c0 = sp * kSpan;
  const T* xj = x + j * static_cast<int64_t>(R) * C;
  unsigned live = 0, odds = 0;
  if (vec) {   // float only: 16-byte loads, C % 4 == 0 and a 16-byte aligned base
    constexpr int kRow4 = kSpan / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < TR * kRow4; e += kThreads) {
      const int r = r0 + e / kRow4;
      const int c = c0 + (e % kRow4) * 4;
      if (r < R && c < C) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(xj) + static_cast<int64_t>(r) * C + c));
        const unsigned bit = 1u << ((c - c0) / TC);
        if (v.x != neg_inf() || v.y != neg_inf() || v.z != neg_inf() || v.w != neg_inf())
          live |= bit;
        if (odd(v.x) || odd(v.y) || odd(v.z) || odd(v.w)) odds |= bit;
      }
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < TR * kSpan; e += kThreads) {
      const int r = r0 + e / kSpan;
      const int c = c0 + e % kSpan;
      if (r < R && c < C) {
        const float v = load_f(xj + static_cast<int64_t>(r) * C + c);
        const unsigned bit = 1u << ((c - c0) / TC);
        if (v != neg_inf()) live |= bit;
        if (odd(v)) odds |= bit;
      }
    }
  }
  live = __reduce_or_sync(0xffffffffu, live);
  odds = __reduce_or_sync(0xffffffffu, odds);
  if ((threadIdx.x & 31) == 0) {
    if (live) atomicOr(block_masks, live);
    if (odds) atomicOr(block_masks + 1, odds);
  }
  __syncthreads();
  const int tc = sp * kSpanTiles + static_cast<int>(threadIdx.x);
  if (threadIdx.x < kSpanTiles && tc < CT) {
    const int64_t at = col_major ? (j * CT + tc) * RT + rt : (j * RT + rt) * CT + tc;
    flags[at] = static_cast<uint8_t>(((block_masks[0] >> threadIdx.x) & 1u) * kLive |
                                     ((block_masks[1] >> threadIdx.x) & 1u) * kOdd);
  }
}

// The first `blocks_a` blocks flag A's (kBM x kBK) tiles as (J, RT, KT),
// the rest B's (kBK x kBN) tiles as (J, CT, KT).
template <typename T>
__global__ void __launch_bounds__(kThreads)
occupancy_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 uint8_t* __restrict__ fa, uint8_t* __restrict__ fb, int m, int k,
                 int n, int64_t blocks_a, bool vec_a, bool vec_b) {
  __shared__ unsigned block_masks[2];   // live, odd
  if (threadIdx.x < 2) block_masks[threadIdx.x] = 0;
  __syncthreads();
  const int64_t blk = blockIdx.x;
  if (blk < blocks_a)
    occupancy<T, kBM, kBK>(a, fa, m, k, blk, vec_a, false, block_masks);
  else
    occupancy<T, kBK, kBN>(b, fb, k, n, blk - blocks_a, vec_b, true, block_masks);
}

// ---------------------------------------------------------------------------
// The product. One block computes a kBM x kBN output tile of one batch
// row j over the k tiles the flags list.
template <typename T, bool VA, bool VB>
__device__ __forceinline__ void load_stage(float* As, float* Bs, const T* a_j, const T* b_j,
                                           int row0, int col0, int k0, int m, int k, int n) {
  const int tid = threadIdx.x;
  if (VA) {   // 16-byte chunks, 4 k values of one row
#pragma unroll
    for (int c = tid; c < kBM * kBK / 4; c += kThreads) {
      const int r = row0 + (c >> 2);
      const int kc = k0 + ((c & 3) << 2);
      float* dst = As + 4 * c;
      if (r < m && kc < k)
        cp_async16(dst, reinterpret_cast<const float*>(a_j) + static_cast<int64_t>(r) * k + kc);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(neg_inf(), neg_inf(), neg_inf(), neg_inf());
    }
  } else {
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = row0 + e / kBK;
      const int kc = k0 + e % kBK;
      const bool in = r < m && kc < k;
      stage_one(As + e, a_j + (in ? static_cast<int64_t>(r) * k + kc : 0), in);
    }
  }
  if (VB) {   // 16-byte chunks, 4 columns at one k
#pragma unroll
    for (int c = tid; c < kBK * kBN / 4; c += kThreads) {
      const int kc = k0 + c / (kBN / 4);
      const int cc = col0 + (c % (kBN / 4)) * 4;
      float* dst = Bs + 4 * c;
      if (kc < k && cc < n)
        cp_async16(dst, reinterpret_cast<const float*>(b_j) + static_cast<int64_t>(kc) * n + cc);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(neg_inf(), neg_inf(), neg_inf(), neg_inf());
    }
  } else {
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kc = k0 + e / kBN;
      const int cc = col0 + e % kBN;
      const bool in = kc < k && cc < n;
      stage_one(Bs + e, b_j + (in ? static_cast<int64_t>(kc) * n + cc : 0), in);
    }
  }
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// A thread's 8 x 8 accumulators are walked as two halves of rows (h) by
// two groups of four columns (g), so only four rows of A and four columns
// of B sit in registers beside them.

// One stage on float compares: one FMNMX for the min and one for the max
// per (i, c, k).
__device__ __forceinline__ void compute_stage(const float* __restrict__ As,
                                              const float* __restrict__ Bs,
                                              float (&acc)[8][8], int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(As + (h * 64 + ty * 4 + i) * kBK + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const float4 b = *reinterpret_cast<const float4*>(Bs + (kk + q) * kBN + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ai = lane4(av[i], q);
            float (&row)[8] = acc[h * 4 + i];
            row[g * 4 + 0] = fmaxf(row[g * 4 + 0], fminf(ai, b.x));
            row[g * 4 + 1] = fmaxf(row[g * 4 + 1], fminf(ai, b.y));
            row[g * 4 + 2] = fmaxf(row[g * 4 + 2], fminf(ai, b.z));
            row[g * 4 + 3] = fmaxf(row[g * 4 + 3], fminf(ai, b.w));
          }
        }
      }
    }
  }
}

// max(acc, min(a0, b0), min(a1, b1)) on the values' bits as signed ints:
// two integer mins and one three-input max (`__vimax3_s32`, one DPX
// instruction on Hopper).
__device__ __forceinline__ float fold2(float acc, int a0, float b0, int a1, float b1) {
  return __int_as_float(__vimax3_s32(__float_as_int(acc), min(a0, __float_as_int(b0)),
                                     min(a1, __float_as_int(b1))));
}

// One stage on the bits as ints, for tiles with no odd value: two k at a
// time, 1.5 instructions per (i, c, k) instead of 2. The accumulators hold
// the same bits either way.
__device__ __forceinline__ void compute_stage_int(const float* __restrict__ As,
                                                  const float* __restrict__ Bs,
                                                  float (&acc)[8][8], int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(As + (h * 64 + ty * 4 + i) * kBK + kk);
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const float4 b = *reinterpret_cast<const float4*>(Bs + (kk + q) * kBN + g * 64 + tx * 4);
          const float4 d =
              *reinterpret_cast<const float4*>(Bs + (kk + q + 1) * kBN + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int a0 = __float_as_int(lane4(av[i], q));
            const int a1 = __float_as_int(lane4(av[i], q + 1));
            float (&row)[8] = acc[h * 4 + i];
            row[g * 4 + 0] = fold2(row[g * 4 + 0], a0, b.x, a1, d.x);
            row[g * 4 + 1] = fold2(row[g * 4 + 1], a0, b.y, a1, d.y);
            row[g * 4 + 2] = fold2(row[g * 4 + 2], a0, b.z, a1, d.z);
            row[g * 4 + 3] = fold2(row[g * 4 + 3], a0, b.w, a1, d.w);
          }
        }
      }
    }
  }
}

template <typename T, bool VA, bool VB>
__global__ void __launch_bounds__(kThreads, 2)
maxmin_fused_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                    const uint8_t* __restrict__ fa, const uint8_t* __restrict__ fb,
                    int m, int k, int n, bool vec_out) {
  extern __shared__ __align__(16) float stages[];   // kStages x (As | Bs)
  __shared__ int live[kThreads];                    // listed k tiles of one chunk
  __shared__ int warp_live[kThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int rt = blockIdx.y;
  const int ct = blockIdx.x;
  const int row0 = rt * kBM;
  const int col0 = ct * kBN;
  const int KT = (k + kBK - 1) / kBK;
  // 64-bit batch offsets: J * m * n passes 2^31 at J=48, N=8192
  const int64_t jz = blockIdx.z;
  const T* a_j = a + jz * static_cast<int64_t>(m) * k;
  const T* b_j = b + jz * static_cast<int64_t>(k) * n;
  T* out_j = out + jz * static_cast<int64_t>(m) * n;
  const uint8_t* fa_t = fa + (jz * gridDim.y + rt) * KT;   // A's k tiles of this row tile
  const uint8_t* fb_t = fb + (jz * gridDim.x + ct) * KT;   // B's k tiles of this col tile
  // warp-uniform: this warp's rows are 8w..8w+7 and 64+8w..64+8w+7
  const bool computes = row0 + 8 * warp < m;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = neg_inf();

  // the integer path, when no tile this block will run holds an odd value
  int any_odd = 0;
  for (int kt = tid; kt < KT; kt += kThreads) {
    const int f = fa_t[kt] & fb_t[kt] & kLive ? (fa_t[kt] | fb_t[kt]) : 0;
    any_odd |= f & kOdd;
  }
  const bool ints = !__syncthreads_or(any_odd);

  for (int base = 0; base < KT; base += kThreads) {
    // list the chunk's k tiles where both operand tiles hold an entry
    const int kt = base + tid;
    const bool on = kt < KT && (fa_t[kt] & fb_t[kt] & kLive);
    const unsigned vote = __ballot_sync(0xffffffffu, on);
    if (lane == 0) warp_live[warp] = __popc(vote);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int c = warp_live[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (on) live[before + __popc(vote & ((1u << lane) - 1u))] = kt;
    __syncthreads();

    // stream the listed tiles through the ring
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < total)
        load_stage<T, VA, VB>(stages + s * kStageFloats, stages + s * kStageFloats + kBM * kBK,
                              a_j, b_j, row0, col0, live[s] * kBK, m, k, n);
      cp_async_commit();
    }
    for (int i = 0; i < total; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // tile i is in; every warp is done with tile i - 1
      const int nxt = i + kStages - 1;
      if (nxt < total) {
        float* st = stages + (nxt % kStages) * kStageFloats;
        load_stage<T, VA, VB>(st, st + kBM * kBK, a_j, b_j, row0, col0, live[nxt] * kBK,
                              m, k, n);
      }
      cp_async_commit();
      if (computes) {
        const float* st = stages + (i % kStages) * kStageFloats;
        if (ints) compute_stage_int(st, st + kBM * kBK, acc, tx, ty);
        else compute_stage(st, st + kBM * kBK, acc, tx, ty);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring and the list are free for the next chunk
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + h * 64 + ty * 4 + i;
      if (r >= m) continue;
      T* orow = out_j + static_cast<int64_t>(r) * n;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int cc = col0 + g * 64 + tx * 4;
        if (vec_out && cc + 3 < n) {   // float only: n % 4 == 0, aligned base
          *reinterpret_cast<float4*>(reinterpret_cast<float*>(orow) + cc) =
              make_float4(acc[h * 4 + i][g * 4], acc[h * 4 + i][g * 4 + 1],
                          acc[h * 4 + i][g * 4 + 2], acc[h * 4 + i][g * 4 + 3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (cc + c < n) store_f(orow + cc + c, acc[h * 4 + i][g * 4 + c]);
        }
      }
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int64_t cdiv(int64_t x, int64_t y) { return (x + y - 1) / y; }

// Flag bytes for one call: A's (J, RT, KT), then B's (J, CT, KT).
int64_t flag_bytes(int J, int m, int k, int n) {
  const int64_t KT = cdiv(k, kBK);
  return static_cast<int64_t>(J) * KT * (cdiv(m, kBM) + cdiv(n, kBN));
}

template <typename T, bool VA, bool VB>
cudaError_t launch_product(const T* a, const T* b, T* out, const uint8_t* fa,
                           const uint8_t* fb, int J, int m, int k, int n, bool vec_out,
                           cudaStream_t stream) {
  // the attribute belongs to the device: set it once per instantiation and
  // device (a launch on another card without it fails)
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(
        maxmin_fused_kernel<T, VA, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>(cdiv(n, kBN)), static_cast<unsigned>(cdiv(m, kBM)),
                  static_cast<unsigned>(J));
  maxmin_fused_kernel<T, VA, VB><<<grid, kThreads, kSmemBytes, stream>>>(
      a, b, out, fa, fb, m, k, n, vec_out);
  return cudaGetLastError();
}

// The tile table lives in repro_torch/kernels/maxmin/maxmin.py
// (`_TILE_BM`); `bm` names the entry. Unknown entries are refused.
template <typename T>
int dispatch(const T* a, const T* b, T* out, uint8_t* flags, int64_t n_flags, int J,
             int m, int k, int n, int bm, void* stream) {
  if (J < 1 || m < 1 || k < 1 || n < 1 || J > 65535) return (int)cudaErrorInvalidValue;
  if (bm != kBM) return (int)cudaErrorInvalidValue;   // 128: the one entry
  if (n_flags < flag_bytes(J, m, k, n)) return (int)cudaErrorInvalidValue;
  if (cdiv(m, kBM) > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kFloat = sizeof(T) == 4;
  const bool va = kFloat && k % 4 == 0 && aligned16(a);
  const bool vb = kFloat && n % 4 == 0 && aligned16(b);
  const bool vec_out = kFloat && n % 4 == 0 && aligned16(out);
  uint8_t* fa = flags;
  uint8_t* fb = flags + static_cast<int64_t>(J) * cdiv(m, kBM) * cdiv(k, kBK);
  const int64_t KT = cdiv(k, kBK);
  const int64_t blocks_a = static_cast<int64_t>(J) * cdiv(m, kBM) * cdiv(KT, kSpanTiles);
  const int64_t blocks_b = static_cast<int64_t>(J) * KT * cdiv(cdiv(n, kBN), kSpanTiles);
  if (blocks_a + blocks_b > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  occupancy_kernel<T><<<static_cast<unsigned>(blocks_a + blocks_b), kThreads, 0, s>>>(
      a, b, fa, fb, m, k, n, blocks_a, va, vb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (va && vb) err = launch_product<T, true, true>(a, b, out, fa, fb, J, m, k, n, vec_out, s);
  else if (va) err = launch_product<T, true, false>(a, b, out, fa, fb, J, m, k, n, vec_out, s);
  else if (vb) err = launch_product<T, false, true>(a, b, out, fa, fb, J, m, k, n, vec_out, s);
  else err = launch_product<T, false, false>(a, b, out, fa, fb, J, m, k, n, vec_out, s);
  return (int)err;
}

// ---------------------------------------------------------------------------
// Measurement only: the throughput of one instruction. Every thread runs
// kChains independent dependency chains of `iters` x kUnroll steps; the
// empty asm after each step hides the chain from the compiler, so
// max(max(x, y), y) is not folded away.
constexpr int kChains = 8;
constexpr int kUnroll = 16;

template <int OP>
__global__ void __launch_bounds__(kThreads)
minmax_rate_kernel(int iters, int seed, int* sink) {
  int acc[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc[c] = seed + c * 7 + static_cast<int>(threadIdx.x);
  const int x = seed ^ 0x5a5a5a5a;
  const int y = seed * 3 + 1;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        if (OP == 0) {        // FFMA
          float f = __int_as_float(acc[c]);
          f = fmaf(f, __int_as_float(x), __int_as_float(y));
          acc[c] = __float_as_int(f);
        } else if (OP == 1) { // FMNMX
          acc[c] = __float_as_int(fmaxf(__int_as_float(acc[c]), __int_as_float(u & 1 ? x : y)));
        } else if (OP == 2) { // two-input integer min/max: min and max in
                              // turn, which no three-input instruction fuses
          acc[c] = u & 1 ? max(acc[c], x) : min(acc[c], y);
        } else {              // three-input integer max (DPX)
          acc[c] = __vimax3_s32(acc[c], x, y);
        }
        asm volatile("" : "+r"(acc[c]));
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s ^= acc[c];
  sink[blockIdx.x * kThreads + threadIdx.x] = s;
}

template <int OP>
int rate_launch(int blocks, int iters, int seed, int* sink, void* stream) {
  minmax_rate_kernel<OP><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, seed, sink);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long maxmin_flag_bytes(int J, int m, int k, int n, int bm) {
  if (bm != kBM || J < 1 || m < 1 || k < 1 || n < 1) return -1;
  return flag_bytes(J, m, k, n);
}

extern "C" int maxmin_fused_f32(const float* a, const float* b, float* out, uint8_t* flags,
                                long long n_flags, int J, int m, int k, int n, int bm,
                                void* stream) {
  return dispatch<float>(a, b, out, flags, n_flags, J, m, k, n, bm, stream);
}

extern "C" int maxmin_fused_f16(const __half* a, const __half* b, __half* out,
                                uint8_t* flags, long long n_flags, int J, int m, int k,
                                int n, int bm, void* stream) {
  return dispatch<__half>(a, b, out, flags, n_flags, J, m, k, n, bm, stream);
}

// B2: the single-pair product (J = 1)
extern "C" int maxmin_f32(const float* a, const float* b, float* out, uint8_t* flags,
                          long long n_flags, int m, int k, int n, int bm, void* stream) {
  return dispatch<float>(a, b, out, flags, n_flags, 1, m, k, n, bm, stream);
}

extern "C" int maxmin_f16(const __half* a, const __half* b, __half* out, uint8_t* flags,
                          long long n_flags, int m, int k, int n, int bm, void* stream) {
  return dispatch<__half>(a, b, out, flags, n_flags, 1, m, k, n, bm, stream);
}

// The instruction-rate microbenchmark: op 0 FFMA, 1 FMNMX, 2 integer min/max,
// 3 __vimax3_s32.
extern "C" int minmax_rate(int op, int blocks, int iters, int seed, int* sink,
                           void* stream) {
  switch (op) {
    case 0: return rate_launch<0>(blocks, iters, seed, sink, stream);
    case 1: return rate_launch<1>(blocks, iters, seed, sink, stream);
    case 2: return rate_launch<2>(blocks, iters, seed, sink, stream);
    case 3: return rate_launch<3>(blocks, iters, seed, sink, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks of the microbenchmark per SM, for a grid of one wave.
extern "C" int minmax_rate_blocks_per_sm(int op) {
  int n = 0;
  cudaError_t err;
  switch (op) {
    case 0: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, minmax_rate_kernel<0>, kThreads, 0); break;
    case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, minmax_rate_kernel<1>, kThreads, 0); break;
    case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, minmax_rate_kernel<2>, kThreads, 0); break;
    case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, minmax_rate_kernel<3>, kThreads, 0); break;
    default: return -1;
  }
  return err == cudaSuccess ? n : -1;
}
