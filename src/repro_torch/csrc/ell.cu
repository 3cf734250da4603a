// Kernel B5: the ELL gather-contract with the spill ring (bottleneck
// semiring) on Hopper.
//
//     out[j, m, v] = max( max over e with idx[l, u, e] == v of
//                             min(d[j, m, u], ts[l, u, e]),
//                         max over s with spill_lab[s] == l, spill_dst[s] == v
//                             of min(d[j, m, spill_src[s]], spill_ts[s]) )
//     with l = labs[j]; the semiring zero where no term exists
//
// d (J, M, U), the ELL leaves idx (L, U, E) int32 and ts (L, U, E), labs
// (J,) int32 or int64, the spill ring's four (S,) leaves (src, dst, lab
// int32, ts) and out (J, M, U), all row-major and contiguous. The zero is
// -inf on float32 timestamps (`ell_contract_rows_f32`) and level 0 on the
// bucket backend's int32 levels (`ell_contract_rows_s32`); free ELL slots
// and free ring entries carry it and fold away. A null `labs` reads label
// j for row j, and S = 0 folds no ring: the gather-contract of the Pallas
// kernel on pre-gathered rows (`ell_gather_contract`), which is the same
// kernel with the identity labels and an empty ring.
//
// Replaces `_ell_kernel` / `ell_gather_contract_fused`
// (repro/kernels/ell/ell.py:39-97), the Pallas TPU kernel that keeps a
// whole-width output row block in VMEM as its accumulator and walks the
// ELL slots in series, plus the work the reference does around it: the
// (J, U, E) gathers `ell.idx[labs]`, `ell.ts[labs]` and the spill-ring
// fold `_fold_spill` (repro/core/backend.py:159-180).
//
// What bounds it: d read once and out written once, the L * U * E ELL
// leaves and the ring read once: 4 * 2 * J*M*U + 8 * L*U*E + 16 * S bytes
// over 3.35 TB/s, against 2 min/max operations per live candidate; at
// E <= 8 that is under 2 operations per byte, so the bound is the memory
// traffic. The engine's dist rows are nearly all zero (0.03% of the
// frontier's d entries and under 0.001% of a dense round's are live on
// chip_smoke.py's phase 6), so B5 is a stream: d in, out back. The
// design keeps that stream moving:
//   * a tile is one output row of one transition row j: a CTA keeps the
//     row's `vw` columns (all of U when it fits, see `plan`) in shared
//     memory as order-preserving int keys, so one integer atomicMax in
//     shared memory folds a float32 candidate exactly: no global fill, no
//     global atomics, each output word written once, in 16-byte stores;
//   * each thread streams its own 16-byte groups of the d row into shared
//     memory with cp.async, kStages stages of kChunk values deep, running
//     ahead across tile boundaries, and reads back only what it copied
//     itself, so no barrier guards a stage;
//   * a zero d entry drops out at once. A warp queues its live entries in
//     shared memory (ballot and popc) and folds them 32 at a time, one a
//     lane: each walks the E slots of ELL row (labs[j], u) straight from
//     the leaves, which stay in L2 (1 MB at L = 4, U = 8192, E = 4), so a
//     warp waits on those loads once per 32 live entries;
//   * the spill ring is read once per CTA (an entry a thread); at a
//     tile's start the entries on its label read their d value, which
//     arrives while the row streams in, and fold with the same atomics at
//     the tile's end: the ring costs no launch of its own;
//   * after writing the row out, each thread puts the zero key back into
//     the shared words it has just read, so the next tile starts clean
//     without a fill pass (two barriers per tile);
//   * a strided grid of as many CTAs as fit on the card at once, each
//     given the same number of tiles, walks the J * M * ceil(U / vw)
//     tiles, so the frontier's 640 rows and a dense round's chunk of
//     32768 rows both fill the 132 SMs;
//   * a row wider than kTileBytes is split over v: each CTA streams the
//     whole d row and keeps the candidates in its own columns, so any U is
//     right. U % 4 != 0 or a misaligned base takes the same kernel with
//     4-byte copies and stores.
// Max is order-independent, so the result is bit-identical to the plain
// version however the atomics interleave.
//
// Numerics: an ELL index or a ring src or dst outside [0, U) is dropped,
// as JAX's scatter drops out-of-range updates (JAX's gather would clamp a
// src; the engine's leaves hold no such entry). A label outside [0, L)
// reads no ELL row. Keys: a float's bits with the low 31 bits flipped when
// the sign is set order as signed ints exactly as the floats do (no NaN;
// -0.0 orders below +0.0). fminf differs from jnp.minimum only on NaN,
// and the engine's timestamps hold none. Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 5;            // blocks an SM holds at U = 8192
constexpr int kChunk = 1024;             // d values a stage holds
constexpr int kStages = 2;               // cp.async ring: kStages - 1 in flight
constexpr int kPerThread = kChunk / (4 * kThreads);   // 4-value groups a stage
constexpr int kQueue = 64;               // live d entries a warp holds, at most
constexpr int kTileBytes = 96 * 1024;    // accumulator of one tile, at most
static_assert(kChunk % (4 * kThreads) == 0, "a stage is whole 4-value groups");

// The two lattices: float32 timestamps (zero -inf) and int32 levels (zero 0).
__device__ __forceinline__ float zero_of(float) { return __int_as_float(0xff800000); }
__device__ __forceinline__ int zero_of(int) { return 0; }
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ int min_of(int a, int b) { return min(a, b); }
// Order-preserving int key and its inverse (the same involution).
__device__ __forceinline__ int key_of(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ int key_of(int x) { return x; }
__device__ __forceinline__ float value_of(int k, float) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}
__device__ __forceinline__ int value_of(int k, int) { return k; }

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
struct Args {
  const T* d;
  const int* idx;
  const T* ts;
  const void* labs;       // (J,) int32 or int64; null: label j for row j
  const int* sp_src;
  const int* sp_dst;
  const int* sp_lab;
  const T* sp_ts;
  T* out;
  int J, M, U, E, L, S;
  int lab_bytes;          // 4 or 8
  int vw, v_tiles;        // a tile: one output row's columns [v0, v0 + vw)
  int nc;                 // stages of d a row takes: ceil(U / kChunk)
  long long n_tiles;      // J * M * v_tiles
};

// What a live d entry folds into: the ELL rows of label l, and the tile
// `acc` whose columns are [v0, v0 + vn).
template <typename T>
struct Target {
  const int* idx;
  const T* ts;
  int U, E, l, v0, vn;
  int* acc;
};

// Fold one live d[j, m, u] through the E slots of ELL row (l, u).
template <typename T>
__device__ __forceinline__ void fold_slots(const Target<T>& t, T dv, int u) {
  const T zero = zero_of(T());
  const long long slot0 = ((long long)t.l * t.U + u) * t.E;
#pragma unroll 4
  for (int e = 0; e < t.E; ++e) {
    const T c = min_of(dv, __ldg(t.ts + slot0 + e));
    const int v = __ldg(t.idx + slot0 + e) - t.v0;
    if (c > zero && (unsigned)v < (unsigned)t.vn) atomicMax(t.acc + v, key_of(c));
  }
}

// Warp-wide, one d entry a lane: append the live ones to the warp's
// queue (qu, qd) and, once 32 are queued, fold them, one a lane. A warp
// thus waits on the ELL slots' loads once per 32 live entries, not once
// per step in which any of its lanes holds one. Returns the new count.
template <typename T>
__device__ __forceinline__ int push(const Target<T>& t, int* qu, T* qd, int cnt,
                                    int lane, T dv, int u) {
  const bool live = dv > zero_of(T());
  const unsigned m = __ballot_sync(0xffffffffu, live);
  if (m == 0) return cnt;
  if (live) {
    const int pos = cnt + __popc(m & ((1u << lane) - 1));
    qu[pos] = u;
    qd[pos] = dv;
  }
  cnt += __popc(m);
  if (cnt >= 32) {
    __syncwarp();
    fold_slots(t, qd[lane], qu[lane]);
    const bool move = lane < cnt - 32;
    int mu = 0;
    T md = T();
    if (move) {
      mu = qu[32 + lane];
      md = qd[32 + lane];
    }
    __syncwarp();
    if (move) {
      qu[lane] = mu;
      qd[lane] = md;
    }
    __syncwarp();
    cnt -= 32;
  }
  return cnt;
}

// Fold ring entry (lab, ts, src, dst) into the tile when it is on label
// l, live, and its dst lies in the tile's columns.
template <typename T>
__device__ __forceinline__ void fold_ring(const T* drow, int U, int l, int v0, int vn,
                                          int* acc, int lab, T ts, int src, int dst) {
  const T zero = zero_of(T());
  const int v = dst - v0;
  if (lab != l || !(ts > zero) || (unsigned)v >= (unsigned)vn ||
      (unsigned)src >= (unsigned)U) {
    return;
  }
  const T c = min_of(__ldg(drow + src), ts);
  if (c > zero) atomicMax(acc + v, key_of(c));
}

// The d row of a tile: tile = (j * M + m) * v_tiles + vt.
template <typename T>
__device__ __forceinline__ const T* row_of(const Args<T>& a, long long tile) {
  return a.d + (tile / a.v_tiles) * a.U;
}

// Start the copy of stage `c` of d row `drow` into `stage`: each thread
// copies its own kPerThread 4-value groups and later reads only those, so
// no barrier guards a stage. 16-byte copies when kVec, else 4-byte ones.
template <typename T, bool kVec>
__device__ __forceinline__ void issue(const T* drow, int U, int c, T* stage) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int g = threadIdx.x + k * kThreads;        // 4-value group in the stage
    const int u = c * kChunk + 4 * g;
    if (kVec) {
      if (u < U) cp_async16(stage + 4 * g, drow + u);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (u + e < U) cp_async4(stage + 4 * g + e, drow + u + e);
      }
    }
  }
}

// One CTA walks its tiles (blockIdx.x, + gridDim.x, ...), each tile the
// nc stages of its d row, through a cp.async ring of kStages stages that
// runs ahead across tile boundaries. Shared memory: the tile's
// accumulator (vw int keys, rounded up to 16 bytes), the stages, then
// each warp's queue of kQueue live entries (u, then d).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ell_contract_kernel(const Args<T> a) {
  using V = typename Vec4<T>::type;
  extern __shared__ int4 smem4[];
  int* acc = reinterpret_cast<int*>(smem4);
  const int acc_words = (a.vw + 3) / 4 * 4;
  T* stages = reinterpret_cast<T*>(acc + acc_words);
  const int lane = threadIdx.x & 31;
  int* qu = acc + acc_words + kStages * kChunk + (threadIdx.x >> 5) * kQueue;
  T* qd = reinterpret_cast<T*>(acc + acc_words + kStages * kChunk + kWarps * kQueue) +
          (threadIdx.x >> 5) * kQueue;
  const T zero = zero_of(T());
  const int zkey = key_of(zero);
  for (int i = threadIdx.x; i < a.vw; i += kThreads) acc[i] = zkey;
  __syncthreads();

  const long long step = gridDim.x;
  const long long my_tiles = (a.n_tiles - blockIdx.x + step - 1) / step;
  const long long total = my_tiles * a.nc;
  // the producer's position: the tile and stage it copies next
  long long p_tile = blockIdx.x;
  int p_c = 0;
  const T* p_row = row_of(a, p_tile);
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < total) {
      issue<T, kVec>(p_row, a.U, p_c, stages + (p % kStages) * kChunk);
      if (++p_c == a.nc) {
        p_c = 0;
        p_tile += step;
        p_row = row_of(a, p_tile);
      }
    }
    cp_async_commit();
  }

  // this thread's ring entry (the ring is the same for every tile)
  int r_lab = 0, r_src = 0, r_dst = 0;
  T r_ts = zero;
  if (threadIdx.x < a.S) {
    r_lab = __ldg(a.sp_lab + threadIdx.x);
    r_ts = __ldg(a.sp_ts + threadIdx.x);
    r_src = __ldg(a.sp_src + threadIdx.x);
    r_dst = __ldg(a.sp_dst + threadIdx.x);
  }
  long long tile = blockIdx.x;
  int c = 0, cnt = 0, lab = 0;
  T r_dv = zero;                            // d[row, r_src] when the entry folds
  Target<T> t{a.idx, a.ts, a.U, a.E, -1, 0, 0, acc};
  const T* drow = a.d;
  for (long long q = 0; q < total; ++q) {
    if (q + kStages - 1 < total) {
      issue<T, kVec>(p_row, a.U, p_c, stages + ((q + kStages - 1) % kStages) * kChunk);
      if (++p_c == a.nc) {
        p_c = 0;
        p_tile += step;
        p_row = row_of(a, p_tile);
      }
    }
    cp_async_commit();
    if (c == 0) {
      // a new tile: its d row, label and columns
      const int vt = (int)(tile % a.v_tiles);
      const int j = (int)(tile / a.v_tiles / a.M);
      drow = row_of(a, tile);
      lab = j;
      if (a.labs != nullptr) {
        lab = a.lab_bytes == 8 ? (int)__ldg(static_cast<const long long*>(a.labs) + j)
                               : __ldg(static_cast<const int*>(a.labs) + j);
      }
      t.l = lab >= 0 && lab < a.L ? lab : -1;   // -1: no ELL row; the ring still folds
      t.v0 = vt * a.vw;
      t.vn = min(a.vw, a.U - t.v0);
      // this thread's ring entry reads its d value now, folded at the end
      r_dv = zero;
      if (r_lab == lab && r_ts > zero && (unsigned)(r_dst - t.v0) < (unsigned)t.vn &&
          (unsigned)r_src < (unsigned)a.U) {
        r_dv = __ldg(drow + r_src);
      }
    }
    cp_async_wait<kStages - 1>();            // this thread's copies of stage q

    // 1. the ELL slots of every live d entry of the stage
    if (t.l >= 0) {
      const V* st4 = reinterpret_cast<const V*>(stages + (q % kStages) * kChunk);
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int g = threadIdx.x + k * kThreads;
        const int u = c * kChunk + 4 * g;
        V x = st4[g];
        if (u >= a.U) x.x = zero;
        if (u + 1 >= a.U) x.y = zero;
        if (u + 2 >= a.U) x.z = zero;
        if (u + 3 >= a.U) x.w = zero;
        cnt = push(t, qu, qd, cnt, lane, x.x, u);
        cnt = push(t, qu, qd, cnt, lane, x.y, u + 1);
        cnt = push(t, qu, qd, cnt, lane, x.z, u + 2);
        cnt = push(t, qu, qd, cnt, lane, x.w, u + 3);
      }
    }
    if (++c < a.nc) continue;

    // the tile's last stage: the queue's rest and the ring, then write out
    __syncwarp();
    if (lane < cnt) fold_slots(t, qd[lane], qu[lane]);
    __syncwarp();
    cnt = 0;
    c = 0;
    if (r_dv > zero) atomicMax(acc + r_dst - t.v0, key_of(min_of(r_dv, r_ts)));
    for (int s = threadIdx.x + kThreads; s < a.S; s += kThreads) {
      fold_ring(drow, a.U, lab, t.v0, t.vn, acc, __ldg(a.sp_lab + s), __ldg(a.sp_ts + s),
                __ldg(a.sp_src + s), __ldg(a.sp_dst + s));
    }
    __syncthreads();

    // 2. write the tile once and put the zero key back behind the read
    T* orow = a.out + (tile / a.v_tiles) * a.U + t.v0;
    if (kVec) {
      for (int i = threadIdx.x; i < t.vn / 4; i += kThreads) {
        const int4 k = smem4[i];
        smem4[i] = make_int4(zkey, zkey, zkey, zkey);
        V o;
        o.x = value_of(k.x, T());
        o.y = value_of(k.y, T());
        o.z = value_of(k.z, T());
        o.w = value_of(k.w, T());
        reinterpret_cast<V*>(orow)[i] = o;
      }
    } else {
      for (int i = threadIdx.x; i < t.vn; i += kThreads) {
        const int k = acc[i];
        acc[i] = zkey;
        orow[i] = value_of(k, T());
      }
    }
    __syncthreads();
    tile += step;
  }
}

// A tile is one output row, all of U when it fits in kTileBytes, else
// its columns split into equal multiples of 4.
template <typename T>
void plan(Args<T>& a) {
  const long long row_bytes = 4LL * a.U;
  a.v_tiles = (int)((row_bytes + kTileBytes - 1) / kTileBytes);
  a.vw = a.v_tiles == 1 ? a.U : ((a.U + a.v_tiles - 1) / a.v_tiles + 3) / 4 * 4;
  a.v_tiles = (a.U + a.vw - 1) / a.vw;
  a.nc = (a.U + kChunk - 1) / kChunk;
  a.n_tiles = (long long)a.J * a.M * a.v_tiles;
}

template <typename T, bool kVec>
int launch_as(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = ((size_t)(a.vw + 3) / 4 * 4 + (size_t)kStages * kChunk) * 4 +
                      (size_t)kWarps * kQueue * 8;
  auto kernel = ell_contract_kernel<T, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  // as many blocks as fit at once, each given the same number of tiles
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long per_block = (a.n_tiles + fit - 1) / fit;
  const int grid = (int)((a.n_tiles + per_block - 1) / per_block);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* d, const int* idx, const T* ts, const void* labs, int lab_bytes,
           const int* sp_src, const int* sp_dst, const int* sp_lab, const T* sp_ts,
           T* out, int J, int M, int U, int E, int L, int S, void* stream) {
  if (J < 1 || M < 1 || U < 1 || E < 0 || L < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (labs != nullptr && lab_bytes != 4 && lab_bytes != 8) return (int)cudaErrorInvalidValue;
  Args<T> a{d, idx, ts, labs, sp_src, sp_dst, sp_lab, sp_ts, out,
            J, M, U, E, L, S, lab_bytes, 0, 0, 0, 0};
  if (E == 0) a.L = 0;   // no slots: only the ring folds
  plan(a);
  const bool vec = U % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_as<T, true>(a, s) : launch_as<T, false>(a, s);
}

}  // namespace

extern "C" int ell_contract_rows_f32(const float* d, const int* idx, const float* ts,
                                     const void* labs, int lab_bytes, const int* sp_src,
                                     const int* sp_dst, const int* sp_lab,
                                     const float* sp_ts, float* out, int J, int M, int U,
                                     int E, int L, int S, void* stream) {
  return launch<float>(d, idx, ts, labs, lab_bytes, sp_src, sp_dst, sp_lab, sp_ts, out,
                       J, M, U, E, L, S, stream);
}

// The bucket backend's int32 levels (zero 0): the keys are the levels.
extern "C" int ell_contract_rows_s32(const int* d, const int* idx, const int* ts,
                                     const void* labs, int lab_bytes, const int* sp_src,
                                     const int* sp_dst, const int* sp_lab,
                                     const int* sp_ts, int* out, int J, int M, int U,
                                     int E, int L, int S, void* stream) {
  return launch<int>(d, idx, ts, labs, lab_bytes, sp_src, sp_dst, sp_lab, sp_ts, out,
                     J, M, U, E, L, S, stream);
}
