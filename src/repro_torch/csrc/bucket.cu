// Kernels B3 and B4: the level-quantized bottleneck product on Hopper's
// int8 tensor cores.
//
//     out[j, i, n] = max_k min(a[j, i, k], b[j, k, n])      on levels
//                  = sum_{theta=1..T} [ sum_k (a >= theta)(b >= theta) > 0 ]
//
// a (J, m, k), b (J, k, n), out (J, m, n), int32 levels, row-major and
// contiguous. Level 0 is the semiring zero; levels are clamped to [0, T]
// as they are staged, which is what the threshold sum computes for any
// int32 input (below 1 never reaches, above T counts T), so every input
// gives the plain version's integers.
//
// Replaces `_bucket_fused_kernel` (B3, repro/kernels/bucket/bucket.py:93,
// behind `bucket_maxmin_fused`, which the mxu_bucket backend's closure
// rounds call once for all J transition rows) and `_bucket_kernel` (B4,
// bucket.py:24, behind `bucket_maxmin`, the single-pair form: this file's
// kernel launched with J = 1).
//
// What bounds it: T boolean products of 2*m*k*n int8 operations each,
// 6.2e12 at the main path's (J=40, m=k=n=2048, T=9), against 2.0 GB of
// int32 operands and output: ~3000 operations per byte, so the bound is
// the int8 tensor-core rate (1979 TOP/s dense on an H100 SXM). The design
// keeps the TPU kernel's point, reading each level tile once for all T
// thresholds:
//   * a block computes a 64 x 64 output tile of one row j with 4 warps,
//     each a 32 x 32 warp tile of 2 x 4 `mma.sync.m16n8k32` s8 tiles;
//   * per 64-deep k step the block stages the int32 level tiles of a and
//     b in shared memory ONCE, narrowed to int8 (b transposed, k-major per
//     column, the fragment order `mma ... .row.col` reads); each warp loads
//     its level fragments into registers once;
//   * for theta = 1..T the fragments are binarized in registers, four
//     levels per instruction group ((x + 0x80 - theta) has bit 7 set per
//     byte iff x >= theta, with no carry between bytes since x <= 127), and
//     fed to the tensor cores into a fresh int32 accumulator; the 0/1
//     counts of one k step (at most 64) are then folded into one running
//     level per output element: best = max(best, theta) where the count is
//     non-zero. Reachability is monotone in theta, so this max equals the
//     threshold sum, and T accumulators never have to live at once: the
//     register cost is the same for every T;
//   * when no element of a warp tile reaches theta in a k step, none
//     reaches a higher one (monotone again), so the warp leaves the theta
//     loop for that step. Exact; it only saves work on sparse levels.
// Left for later work: wgmma, TMA and a multi-stage pipeline, a tile for
// the frontier's skinny (m <= 32) slabs, and skipping thresholds below a
// warp tile's running level.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;      // 4 warps, 2 x 2 warp tiles of 32 x 32
// shared-memory row stride in 32-bit words: 16 words of levels + 4 of pad,
// so the 8 rows x 4 words a fragment load touches fall in 32 distinct banks
constexpr int kRowWords = kBK / 4 + 4;
constexpr int kMaxLevels = 127;    // levels are staged as int8

__device__ __forceinline__ int clamp_level(int v, int t) { return min(max(v, 0), t); }

__device__ __forceinline__ uint32_t pack4(int v0, int v1, int v2, int v3) {
  return (uint32_t)v0 | ((uint32_t)v1 << 8) | ((uint32_t)v2 << 16) | ((uint32_t)v3 << 24);
}

// 0x01 per byte of x (four levels in [0, 127]) that is >= theta, else 0x00
__device__ __forceinline__ uint32_t binarize(uint32_t x, uint32_t add) {
  return ((x + add) >> 7) & 0x01010101u;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
bucket_maxmin_kernel(const int* __restrict__ a, const int* __restrict__ b,
                     int* __restrict__ out, int m, int k, int n, int t_levels) {
  // As[i][k]: rows of a; Bs[c][k]: columns of b (transposed); int8 levels
  // packed four to a word
  __shared__ uint32_t As[kBM * kRowWords];
  __shared__ uint32_t Bs[kBN * kRowWords];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;          // fragment group id
  const int tg = lane & 3;          // thread in group
  const int wm = (warp >> 1) * 32;  // warp tile origin in the block tile
  const int wn = (warp & 1) * 32;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  // 64-bit batch offsets: J * m * n passes 2^31 at J=48, N=8192
  const int64_t jz = blockIdx.z;
  const int* a_j = a + jz * (int64_t)m * k;
  const int* b_j = b + jz * (int64_t)k * n;
  int* out_j = out + jz * (int64_t)m * n;

  // running level per output element, in the accumulator fragment order:
  // best[mi][ni][r] is row wm + 16 mi + g + 8 (r >> 1), column
  // wn + 8 ni + 2 tg + (r & 1)
  int best[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) best[mi][ni][r] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // stage a[row0 : row0+64, k0 : k0+64]: one word (four k) per step,
    // k fastest, so a warp reads two 256-byte runs of a row
    for (int w = tid; w < kBM * (kBK / 4); w += kThreads) {
      const int i = w / (kBK / 4);
      const int kw = w % (kBK / 4);
      const int r = row0 + i;
      int v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kc = k0 + kw * 4 + q;
        v[q] = (r < m && kc < k) ? clamp_level(__ldg(a_j + (int64_t)r * k + kc), t_levels) : 0;
      }
      As[i * kRowWords + kw] = pack4(v[0], v[1], v[2], v[3]);
    }
    // stage b[k0 : k0+64, col0 : col0+64] transposed: neighbouring
    // threads take neighbouring columns, so each of the four reads of a
    // word is coalesced
    for (int w = tid; w < kBN * (kBK / 4); w += kThreads) {
      const int c = w % kBN;
      const int kw = w / kBN;
      const int cc = col0 + c;
      int v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kc = k0 + kw * 4 + q;
        v[q] = (kc < k && cc < n) ? clamp_level(__ldg(b_j + (int64_t)kc * n + cc), t_levels) : 0;
      }
      Bs[c * kRowWords + kw] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

    // this warp's level fragments for both 32-deep halves of the k step
    uint32_t af[2][2][4];   // [k half][mi][reg]
    uint32_t bf[2][4][2];   // [k half][ni][reg]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        const int kw = h * 8 + tg;
        af[h][mi][0] = As[r * kRowWords + kw];
        af[h][mi][1] = As[(r + 8) * kRowWords + kw];
        af[h][mi][2] = As[r * kRowWords + kw + 4];
        af[h][mi][3] = As[(r + 8) * kRowWords + kw + 4];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + ni * 8 + g;
        const int kw = h * 8 + tg;
        bf[h][ni][0] = Bs[c * kRowWords + kw];
        bf[h][ni][1] = Bs[c * kRowWords + kw + 4];
      }
    }

    for (int theta = 1; theta <= t_levels; ++theta) {
      const uint32_t add = (uint32_t)(0x80 - theta) * 0x01010101u;
      int acc[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t ab[2][4];
        uint32_t bb[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int q = 0; q < 4; ++q) ab[mi][q] = binarize(af[h][mi][q], add);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          bb[ni][0] = binarize(bf[h][ni][0], add);
          bb[ni][1] = binarize(bf[h][ni][1], add);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], ab[mi], bb[ni][0], bb[ni][1]);
      }
      bool any = false;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const bool hit = acc[mi][ni][r] != 0;
            best[mi][ni][r] = hit ? max(best[mi][ni][r], theta) : best[mi][ni][r];
            any |= hit;
          }
      // reachability is monotone in theta: nothing in this warp tile
      // reaches a higher threshold in this k step either
      if (!__any_sync(0xffffffffu, any)) break;
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + wm + mi * 16 + g + 8 * (r >> 1);
        const int col = col0 + wn + ni * 8 + 2 * tg + (r & 1);
        if (row < m && col < n) out_j[(int64_t)row * n + col] = best[mi][ni][r];
      }
}

int launch(const int* a, const int* b, int* out, int J, int m, int k, int n, int t_levels,
           void* stream) {
  if (J < 1 || m < 1 || k < 1 || n < 1 || J > 65535 || t_levels < 0 ||
      t_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, J);
  bucket_maxmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, m, k, n, t_levels);
  return (int)cudaGetLastError();
}

}  // namespace

// B3: all J transition rows of a round in one launch
extern "C" int bucket_maxmin_fused_s32(const int* a, const int* b, int* out, int J, int m,
                                       int k, int n, int t_levels, void* stream) {
  return launch(a, b, out, J, m, k, n, t_levels, stream);
}

// B4: the single-pair form (J = 1)
extern "C" int bucket_maxmin_s32(const int* a, const int* b, int* out, int m, int k, int n,
                                 int t_levels, void* stream) {
  return launch(a, b, out, 1, m, k, n, t_levels, stream);
}
