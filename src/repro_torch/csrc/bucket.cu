// Kernels B3 and B4: the level-quantized bottleneck product on Hopper's
// int8 tensor cores.
//
//     out[j, i, n] = max_k min(a[j, i, k], b[j, k, n])      on levels
//                  = sum_{theta=1..T} [ sum_k (a >= theta)(b >= theta) > 0 ]
//
// a (J, m, k), b (J, k, n), out (J, m, n), int32 levels, row-major and
// contiguous. Level 0 is the semiring zero; levels are clamped to [0, T]
// (below 0 never reaches a threshold, above T counts T), so every int32
// input gives the plain version's integers.
//
// Replaces `_bucket_fused_kernel` (B3, repro/kernels/bucket/bucket.py:93,
// behind `bucket_maxmin_fused`, which the mxu_bucket backend's closure
// rounds call once for all J transition rows) and `_bucket_kernel` (B4,
// bucket.py:24, behind `bucket_maxmin`, the single-pair form: the same
// kernels launched with J = 1).
//
// What bounds it: on dense levels, T boolean products of 2*m*k*n int8
// operations each (6.2e12 at the path's J=40, m=k=n=2048, T=9) against 2.0
// GB of int32 operands and output, so the int8 tensor-core rate; on the
// path's own operands, which are almost all level 0, the bytes. Reading
// each level tile once for all T thresholds is the TPU kernel's point; the
// design adds what exactness allows it to skip, because reachability is
// monotone in theta:
//   * a level pre-pass (`levels_kernel`, one launch for both operands)
//     reads a and b once. Per (j, 64-row tile, 64-deep k tile) of a and per
//     (j, 128-column tile, k tile) of b it writes one byte, the tile's
//     largest clamped level (0: the tile is all level 0), and it writes the
//     operands clamped and narrowed to int8 into the scratch, a row-major
//     and b transposed (k-major per column, the order `mma ... .row.col`
//     reads), both padded with level 0 to whole tiles. The product reads one
//     byte per level, every copy 16 aligned bytes; the ragged edges and odd
//     strides (k % 4, n % 4, misaligned bases: 4-byte loads instead of 16)
//     are all handled here, once.
//   * the product (`bucket_product_kernel`) computes a 64 x 128 output tile
//     of one row j with 4 warps, each a 64 x 32 warp tile of 4 x 4
//     `mma.sync.m16n8k32` u8 tiles, and keeps one running level per output
//     (`best`). It lists the k tiles where both operand tiles are above level
//     0 (a level-0 tile reaches no threshold), with hi = the smaller of the
//     two flags (no pair of the tile reaches a higher threshold), and streams
//     them in groups of kGroup tiles through two shared-memory buffers filled
//     by cp.async, so the next group loads while this one is computed (two
//     barriers a group). Per group a warp runs only the thresholds in
//     (lo, hi_group], where lo is the lowest running level of its warp tile
//     (a threshold at or below an output's level cannot raise it), and on
//     each tile only those up to the tile's own hi. It leaves the threshold
//     loop when no output of the warp tile reaches theta in the group, and
//     the block leaves the k loop once its lowest running level is at least
//     the largest hi of the tiles still listed.
//   * the integer work around each mma: a level byte x <= 127 becomes 0x80
//     per byte where x >= theta with two instructions, (x + 0x80 - theta) &
//     0x80808080, fed as u8, so a pair that reaches theta adds 128 * 128 =
//     16384 to the count. One count spans a whole group (kGroup * 64 = 256
//     pairs, at most 2^22, so any k is exact) and is folded once per group
//     and threshold with two instructions per output: best = max(best,
//     min(count, theta)), which is theta where the count is non-zero (it is
//     then >= 16384 > theta). The count starts from a zero C operand, and
//     the binarized A fragments of a tile serve all four n8 tiles.
// Outputs outside (m, n) start at level 127, so they never hold lo down; an
// m16 tile wholly past m (the frontier's skinny slabs) is not computed.
// Numerics: integer arithmetic throughout; the order of the k tiles and the
// skipped steps change no bit. Built without --use_fast_math.
//
// Also here, for measurement only and on no path: the product instantiated
// with a counter of the (warp, k tile, theta) steps it runs, through the
// entry `bucket_maxmin_fused_s32_steps`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // product: 4 warps side by side along n
constexpr int kBM = 64;              // output rows per block
constexpr int kBN = 128;             // output columns per block
constexpr int kBK = 64;              // k per tile: the flag and skip granularity
constexpr int kGroup = 4;            // k tiles per count (a 256-deep fold)
constexpr int kTileBytes = (kBM + kBN) * kBK;            // 12 KB: a rows, b columns
constexpr int kSmemBytes = 2 * kGroup * kTileBytes;      // 96 KB, two groups
constexpr int kMaxDevices = 64;  // devices a process configures kernels for
constexpr int kChunk = kThreads;     // k tiles listed at a time
constexpr int kPreThreads = 256;
constexpr int kMaxLevels = 127;      // levels are staged as int8

int64_t cdiv(int64_t x, int64_t y) { return (x + y - 1) / y; }

// Scratch of one call, in bytes from its start: a's flags (J, RT, KT), b's
// flags (J, CT, KT), then (16-byte aligned) a as int8 (J, RT*kBM, KT*kBK)
// and b transposed (J, CT*kBN, KT*kBK). The pre-pass writes every byte.
struct Layout {
  int64_t KT, RT, CT, k_pad, fb, a8, b8, total;
};

Layout layout(int J, int m, int k, int n) {
  Layout L;
  L.KT = cdiv(k, kBK);
  L.RT = cdiv(m, kBM);
  L.CT = cdiv(n, kBN);
  L.k_pad = L.KT * kBK;
  L.fb = static_cast<int64_t>(J) * L.RT * L.KT;
  L.a8 = cdiv(L.fb + static_cast<int64_t>(J) * L.CT * L.KT, 16) * 16;
  L.b8 = L.a8 + static_cast<int64_t>(J) * L.RT * kBM * L.k_pad;
  L.total = L.b8 + static_cast<int64_t>(J) * L.CT * kBN * L.k_pad;
  return L;
}

__device__ __forceinline__ int clamp_level(int v, int t) { return min(max(v, 0), t); }

__device__ __forceinline__ uint32_t pack4(int v0, int v1, int v2, int v3) {
  return static_cast<uint32_t>(v0) | (static_cast<uint32_t>(v1) << 8) |
         (static_cast<uint32_t>(v2) << 16) | (static_cast<uint32_t>(v3) << 24);
}

// ---------------------------------------------------------------------------
// Level pre-pass: one block per tile. The first `blocks_a` blocks take a's
// (kBM x kBK) tiles, the rest b's (kBK x kBN) tiles.
__global__ void __launch_bounds__(kPreThreads)
levels_kernel(const int* __restrict__ a, const int* __restrict__ b,
              uint8_t* __restrict__ scratch, int m, int k, int n, int t_levels, int KT,
              int RT, int CT, int64_t fb_off, int64_t a8_off, int64_t b8_off,
              int64_t blocks_a, bool vec_a, bool vec_b) {
  __shared__ int tile_max;
  __shared__ __align__(16) uint8_t bt[kBN][kBK + 4];   // b's tile, transposed
  const int tid = threadIdx.x;
  if (tid == 0) tile_max = 0;
  __syncthreads();
  const int64_t k_pad = static_cast<int64_t>(KT) * kBK;
  int64_t blk = blockIdx.x;
  int mx = 0;
  uint8_t* flag;
  if (blk < blocks_a) {
    const int kt = static_cast<int>(blk % KT);
    const int64_t t = blk / KT;
    const int rt = static_cast<int>(t % RT);
    const int64_t j = t / RT;
    const int r0 = rt * kBM, k0 = kt * kBK;
    const int* a_j = a + j * static_cast<int64_t>(m) * k;
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        scratch + a8_off + (j * RT * kBM + r0) * k_pad + k0);
    // one word (four k) per step, k fastest: a warp reads two 256-byte rows
    for (int w = tid; w < kBM * (kBK / 4); w += kPreThreads) {
      const int i = w / (kBK / 4), q = w % (kBK / 4);
      const int r = r0 + i, kc = k0 + 4 * q;
      int v[4] = {0, 0, 0, 0};
      if (r < m && kc < k) {
        const int* src = a_j + static_cast<int64_t>(r) * k + kc;
        if (vec_a) {   // k % 4 == 0 and a 16-byte aligned base: kc + 3 < k
          const int4 x = __ldg(reinterpret_cast<const int4*>(src));
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        } else {
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            if (kc + qq < k) v[qq] = __ldg(src + qq);
        }
      }
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        v[qq] = clamp_level(v[qq], t_levels);
        mx = max(mx, v[qq]);
      }
      dst[static_cast<int64_t>(i) * (k_pad / 4) + q] = pack4(v[0], v[1], v[2], v[3]);
    }
    flag = scratch + (j * RT + rt) * KT + kt;
  } else {
    blk -= blocks_a;
    const int kt = static_cast<int>(blk % KT);
    const int64_t t = blk / KT;
    const int ct = static_cast<int>(t % CT);
    const int64_t j = t / CT;
    const int k0 = kt * kBK, c0 = ct * kBN;
    const int* b_j = b + j * static_cast<int64_t>(k) * n;
    // read the tile with columns fastest (coalesced), transpose in shared
    if (vec_b) {   // n % 4 == 0 and a 16-byte aligned base: cc + 3 < n
      for (int e = tid; e < kBK * (kBN / 4); e += kPreThreads) {
        const int kk = e / (kBN / 4), c = (e % (kBN / 4)) * 4;
        const int kr = k0 + kk, cc = c0 + c;
        int4 x = make_int4(0, 0, 0, 0);
        if (kr < k && cc < n)
          x = __ldg(reinterpret_cast<const int4*>(b_j + static_cast<int64_t>(kr) * n + cc));
        const int v[4] = {clamp_level(x.x, t_levels), clamp_level(x.y, t_levels),
                          clamp_level(x.z, t_levels), clamp_level(x.w, t_levels)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bt[c + q][kk] = static_cast<uint8_t>(v[q]);
          mx = max(mx, v[q]);
        }
      }
    } else {
      for (int e = tid; e < kBK * kBN; e += kPreThreads) {
        const int kk = e / kBN, c = e % kBN;
        const int kr = k0 + kk, cc = c0 + c;
        const int v = (kr < k && cc < n)
                          ? clamp_level(__ldg(b_j + static_cast<int64_t>(kr) * n + cc), t_levels)
                          : 0;
        bt[c][kk] = static_cast<uint8_t>(v);
        mx = max(mx, v);
      }
    }
    __syncthreads();
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        scratch + b8_off + (j * CT * kBN + c0) * k_pad + k0);
    for (int w = tid; w < kBN * (kBK / 4); w += kPreThreads) {
      const int c = w / (kBK / 4), q = w % (kBK / 4);
      dst[static_cast<int64_t>(c) * (k_pad / 4) + q] =
          *reinterpret_cast<const uint32_t*>(&bt[c][4 * q]);
    }
    flag = scratch + fb_off + (j * CT + ct) * KT + kt;
  }
  mx = __reduce_max_sync(0xffffffffu, mx);
  if ((tid & 31) == 0) atomicMax(&tile_max, mx);
  __syncthreads();
  if (tid == 0) *flag = static_cast<uint8_t>(tile_max);
}

// ---------------------------------------------------------------------------
// The product.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 0x80 per byte of x (four levels in [0, 127]) that is >= theta, else 0x00:
// add = (0x80 - theta) per byte, and no byte carries into the next
__device__ __forceinline__ uint32_t binarize(uint32_t x, uint32_t add) {
  return (x + add) & 0x80808080u;
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same from a zero accumulator
__device__ __forceinline__ void mma_u8_zero(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0), "r"(0),
        "r"(0), "r"(0));
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// One k tile (64 deep) of the warp tile at one threshold: the count of
// pairs that reach it, added to acc (or written, kFirst). A tile is stored
// row by row, 64 bytes each: a's 64 rows, then b's 128 columns. A thread
// takes the words 4tg..4tg+3 of its rows and columns with one 16-byte read
// each; words 4tg and 4tg+1 feed the first k32 mma (as the fragment's k
// words tg and tg + 4), 4tg+2 and 4tg+3 the second. a and b take the same
// words, so the two mma together sum over the whole tile.
template <bool kFirst>
__device__ __forceinline__ void tile_mma(int (&acc)[4][4][4], const uint8_t* st, uint32_t add,
                                         int wn, int g, int tg, int mi_live) {
  uint32_t af[4][2][4];   // [mi][k32 half][fragment register], binarized
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (mi < mi_live) {
      const uint4 r0 = lds128(st + (16 * mi + g) * kBK + 16 * tg);
      const uint4 r1 = lds128(st + (16 * mi + g + 8) * kBK + 16 * tg);
      af[mi][0][0] = binarize(r0.x, add);
      af[mi][0][1] = binarize(r1.x, add);
      af[mi][0][2] = binarize(r0.y, add);
      af[mi][0][3] = binarize(r1.y, add);
      af[mi][1][0] = binarize(r0.z, add);
      af[mi][1][1] = binarize(r1.z, add);
      af[mi][1][2] = binarize(r0.w, add);
      af[mi][1][3] = binarize(r1.w, add);
    }
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const uint4 c = lds128(st + (kBM + wn + 8 * ni + g) * kBK + 16 * tg);
    const uint32_t b00 = binarize(c.x, add), b01 = binarize(c.y, add);
    const uint32_t b10 = binarize(c.z, add), b11 = binarize(c.w, add);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (mi < mi_live) {
        if (kFirst) mma_u8_zero(acc[mi][ni], af[mi][0], b00, b01);
        else mma_u8(acc[mi][ni], af[mi][0], b00, b01);
        mma_u8(acc[mi][ni], af[mi][1], b10, b11);
      }
    }
  }
}

// Start the copies of the listed tiles live_kt[p0 .. p0+ng) into `dst`.
__device__ __forceinline__ void load_group(uint8_t* dst, const uint8_t* a_t, const uint8_t* b_t,
                                           const int* live_kt, int p0, int ng, int64_t k_pad) {
  static_assert((kBM + kBN) * (kBK / 16) % kThreads == 0, "whole 16-byte chunks per thread");
  for (int s = 0; s < ng; ++s) {
    const int64_t k0 = static_cast<int64_t>(live_kt[p0 + s]) * kBK;
    uint8_t* st = dst + s * kTileBytes;
#pragma unroll
    for (int i = 0; i < (kBM + kBN) * (kBK / 16) / kThreads; ++i) {
      const int c = static_cast<int>(threadIdx.x) + i * kThreads;
      const int row = c / (kBK / 16), q = c % (kBK / 16);
      const uint8_t* src = row < kBM ? a_t + row * k_pad + k0 + 16 * q
                                     : b_t + (row - kBM) * k_pad + k0 + 16 * q;
      cp_async16(st + 16 * c, src);
    }
  }
}

__device__ __forceinline__ int warp_tile_min(const int (&best)[4][4][4]) {
  int v = kMaxLevels;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) v = min(v, best[mi][ni][r]);
  return __reduce_min_sync(0xffffffffu, v);
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads, 2)
bucket_product_kernel(const uint8_t* __restrict__ scratch, int* __restrict__ out, int m,
                      int k, int n, int KT, int64_t fb_off, int64_t a8_off, int64_t b8_off,
                      bool vec_out, unsigned long long* steps) {
  extern __shared__ __align__(16) uint8_t ring[];   // two groups of kGroup tiles
  __shared__ int live_kt[kChunk];                   // listed k tiles of one chunk
  __shared__ int live_hi[kChunk];                   // and the level each can reach
  __shared__ int suf[kChunk + 1];                   // largest hi from a list position on
  __shared__ int warp_cnt[kThreads / 32];
  __shared__ int warp_max[kThreads / 32];
  __shared__ int warp_lo[kThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;          // fragment group id
  const int tg = lane & 3;          // thread in group
  const int wn = warp * 32;         // warp tile origin along n
  const int ct = blockIdx.x, rt = blockIdx.y;
  const int CT = gridDim.x, RT = gridDim.y;
  const int row0 = rt * kBM, col0 = ct * kBN;
  // 64-bit batch offsets: J * m * n passes 2^31 at J=48, N=8192
  const int64_t jz = blockIdx.z;
  const int64_t k_pad = static_cast<int64_t>(KT) * kBK;
  const uint8_t* fa = scratch + (jz * RT + rt) * KT;            // a's k tiles of this row tile
  const uint8_t* fb = scratch + fb_off + (jz * CT + ct) * KT;   // b's k tiles of this col tile
  const uint8_t* a_t = scratch + a8_off + (jz * RT * kBM + row0) * k_pad;
  const uint8_t* b_t = scratch + b8_off + (jz * CT * kBN + col0) * k_pad;
  int* out_j = out + jz * static_cast<int64_t>(m) * n;
  // m16 tiles that hold a row of the operand (1 or 2 on the skinny slabs)
  const int mi_live = min(4, (m - row0 + 15) / 16);

  // running level per output, in the accumulator fragment order:
  // best[mi][ni][r] is row row0 + 16 mi + g + 8 (r >> 1), column
  // col0 + wn + 8 ni + 2 tg + (r & 1); outputs outside (m, n) hold 127
  int best[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + 16 * mi + g + 8 * (r >> 1);
        const int col = col0 + wn + 8 * ni + 2 * tg + (r & 1);
        best[mi][ni][r] = (row < m && col < n) ? 0 : kMaxLevels;
      }
  int lo = warp_tile_min(best);
  if (lane == 0) warp_lo[warp] = lo;
  __syncthreads();
  int blo = min(min(warp_lo[0], warp_lo[1]), min(warp_lo[2], warp_lo[3]));
  unsigned long long n_steps = 0;
  bool done = false;

  for (int base = 0; base < KT && !done; base += kChunk) {
    // list the chunk's k tiles where both operand tiles are above level 0,
    // and the largest hi of the k tiles after the chunk
    const int kt = base + tid;
    const int hi = kt < KT ? min(static_cast<int>(fa[kt]), static_cast<int>(fb[kt])) : 0;
    const bool on = hi > 0;
    const unsigned vote = __ballot_sync(0xffffffffu, on);
    int later = 0;
    for (int kk = base + kChunk + tid; kk < KT; kk += kThreads)
      later = max(later, min(static_cast<int>(fa[kk]), static_cast<int>(fb[kk])));
    later = __reduce_max_sync(0xffffffffu, later);
    if (lane == 0) {
      warp_cnt[warp] = __popc(vote);
      warp_max[warp] = later;
    }
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int c = warp_cnt[w];
      before += w < warp ? c : 0;
      total += c;
      later = max(later, warp_max[w]);
    }
    if (on) {
      const int p = before + __popc(vote & ((1u << lane) - 1u));
      live_kt[p] = kt;
      live_hi[p] = hi;
    }
    __syncthreads();
    // suf[p] = max(live_hi[p..total), later): a suffix max, per warp with
    // shuffles, then across warps
    int v = tid < total ? live_hi[tid] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_down_sync(0xffffffffu, v, d);
      if (lane + d < 32) v = max(v, o);
    }
    if (lane == 0) warp_max[warp] = v;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w)
      if (w > warp) v = max(v, warp_max[w]);
    suf[tid] = max(v, later);
    if (tid == 0) suf[kChunk] = later;
    __syncthreads();
    if (total == 0) continue;
    if (blo >= suf[0]) break;   // nothing listed can raise an output of the block

    // stream the listed tiles, kGroup at a time, through two buffers
    const int n_groups = (total + kGroup - 1) / kGroup;
    load_group(ring, a_t, b_t, live_kt, 0, min(kGroup, total), k_pad);
    cp_async_commit();
    for (int gi = 0; gi < n_groups; ++gi) {
      if (gi + 1 < n_groups) {
        const int p1 = (gi + 1) * kGroup;
        load_group(ring + ((gi + 1) & 1) * kGroup * kTileBytes, a_t, b_t, live_kt, p1,
                   min(kGroup, total - p1), k_pad);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();   // group gi is in
      const int p0 = gi * kGroup;
      const int ng = min(kGroup, total - p0);
      const uint8_t* buf = ring + (gi & 1) * kGroup * kTileBytes;
      int hg = 0;
      for (int s = 0; s < ng; ++s) hg = max(hg, live_hi[p0 + s]);
      if (lo < hg) {
        // thresholds at or below lo raise nothing in this warp tile, and
        // none above hg is reached by a pair of the group
        for (int theta = lo + 1; theta <= hg; ++theta) {
          const uint32_t add = static_cast<uint32_t>(0x80 - theta) * 0x01010101u;
          int acc[4][4][4];
          int s = 0;
          while (live_hi[p0 + s] < theta) ++s;   // the first tile reaching theta
          tile_mma<true>(acc, buf + s * kTileBytes, add, wn, g, tg, mi_live);
          int ran = 1;
          for (++s; s < ng; ++s) {
            if (live_hi[p0 + s] >= theta) {
              tile_mma<false>(acc, buf + s * kTileBytes, add, wn, g, tg, mi_live);
              ++ran;
            }
          }
          if (kCount) n_steps += ran;
          // fold: theta where the count is non-zero (it is >= 16384 then)
          uint32_t any = 0;
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            if (mi < mi_live) {
#pragma unroll
              for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  any |= static_cast<uint32_t>(acc[mi][ni][r]);
                  best[mi][ni][r] = max(best[mi][ni][r], min(acc[mi][ni][r], theta));
                }
            }
          }
          // monotone in theta: no output of this warp tile reaches a
          // higher threshold in this group either
          if (!__any_sync(0xffffffffu, any != 0)) break;
        }
        lo = warp_tile_min(best);
      }
      if (lane == 0) warp_lo[warp] = lo;
      __syncthreads();   // every warp is done with group gi and posted its lo
      blo = min(min(warp_lo[0], warp_lo[1]), min(warp_lo[2], warp_lo[3]));
      if (blo >= suf[p0 + ng]) {   // block-uniform: the rest raises nothing
        done = true;
        break;
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the buffers and the list are free for the next chunk
  }
  if (kCount && lane == 0 && n_steps) atomicAdd(steps, n_steps);

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * mi + g + 8 * h;
      if (row >= m) continue;
      int* orow = out_j + static_cast<int64_t>(row) * n;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = col0 + wn + 8 * ni + 2 * tg;
        if (vec_out && col + 1 < n) {   // n even, 8-byte aligned base
          *reinterpret_cast<int2*>(orow + col) =
              make_int2(best[mi][ni][2 * h], best[mi][ni][2 * h + 1]);
        } else {
          if (col < n) orow[col] = best[mi][ni][2 * h];
          if (col + 1 < n) orow[col + 1] = best[mi][ni][2 * h + 1];
        }
      }
    }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <bool kCount>
cudaError_t launch_product(const uint8_t* scratch, int* out, int J, int m, int k, int n,
                           const Layout& L, bool vec_out, unsigned long long* steps,
                           cudaStream_t stream) {
  // the attribute belongs to the device: set it once per instantiation and
  // device (a launch on another card without it fails)
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(
        bucket_product_kernel<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>(L.CT), static_cast<unsigned>(L.RT),
                  static_cast<unsigned>(J));
  bucket_product_kernel<kCount><<<grid, kThreads, kSmemBytes, stream>>>(
      scratch, out, m, k, n, static_cast<int>(L.KT), L.fb, L.a8, L.b8, vec_out, steps);
  return cudaGetLastError();
}

int dispatch(const int* a, const int* b, int* out, uint8_t* scratch, int64_t n_scratch, int J,
             int m, int k, int n, int t_levels, unsigned long long* steps, void* stream) {
  if (J < 1 || m < 1 || k < 1 || n < 1 || J > 65535 || t_levels < 0 ||
      t_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(J, m, k, n);
  if (n_scratch < L.total || L.RT > 65535) return (int)cudaErrorInvalidValue;
  const int64_t blocks_a = static_cast<int64_t>(J) * L.RT * L.KT;
  const int64_t blocks_b = static_cast<int64_t>(J) * L.CT * L.KT;
  if (blocks_a + blocks_b > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_a = k % 4 == 0 && aligned(a, 16);
  const bool vec_b = n % 4 == 0 && aligned(b, 16);
  const bool vec_out = n % 2 == 0 && aligned(out, 8);
  levels_kernel<<<static_cast<unsigned>(blocks_a + blocks_b), kPreThreads, 0, s>>>(
      a, b, scratch, m, k, n, t_levels, static_cast<int>(L.KT), static_cast<int>(L.RT),
      static_cast<int>(L.CT), L.fb, L.a8, L.b8, blocks_a, vec_a, vec_b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = steps ? launch_product<true>(scratch, out, J, m, k, n, L, vec_out, steps, s)
              : launch_product<false>(scratch, out, J, m, k, n, L, vec_out, nullptr, s);
  return (int)err;
}

}  // namespace

// Scratch bytes of one call (flags and the int8 operands), -1 if refused.
extern "C" long long bucket_scratch_bytes(int J, int m, int k, int n) {
  if (J < 1 || m < 1 || k < 1 || n < 1) return -1;
  return layout(J, m, k, n).total;
}

// B3: all J transition rows of a round in one launch of each kernel
extern "C" int bucket_maxmin_fused_s32(const int* a, const int* b, int* out, uint8_t* scratch,
                                       long long n_scratch, int J, int m, int k, int n,
                                       int t_levels, void* stream) {
  return dispatch(a, b, out, scratch, n_scratch, J, m, k, n, t_levels, nullptr, stream);
}

// B4: the single-pair form (J = 1)
extern "C" int bucket_maxmin_s32(const int* a, const int* b, int* out, uint8_t* scratch,
                                 long long n_scratch, int m, int k, int n, int t_levels,
                                 void* stream) {
  return dispatch(a, b, out, scratch, n_scratch, 1, m, k, n, t_levels, nullptr, stream);
}

// Measurement only: B3 with the product counting the (warp, k tile, theta)
// steps it runs into *steps (which the caller zeroes).
extern "C" int bucket_maxmin_fused_s32_steps(const int* a, const int* b, int* out,
                                             uint8_t* scratch, long long n_scratch, int J,
                                             int m, int k, int n, int t_levels,
                                             unsigned long long* steps, void* stream) {
  if (steps == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(a, b, out, scratch, n_scratch, J, m, k, n, t_levels, steps, stream);
}
