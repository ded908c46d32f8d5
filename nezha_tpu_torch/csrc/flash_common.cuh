// Shared pieces of the flash-attention training kernels (flash_fwd.cu,
// flash_bwd.cu): tile staging into shared memory, the row limits of
// causal and length masking, and the two warp-level products the first
// bodies are built from (the fp32 forward, dq and dK/dV, and the prefill
// fold; the bf16 flash bodies are built from hopper.cuh), and the launch
// plan every entry point checks.
//
// A thread block has 4 warps and owns 64 rows of its output (queries in
// the forward and dQ kernels, keys in the dK/dV kernel); each warp owns
// 16 of them. The rows the block streams past arrive in 64-row shared
// tiles. Every score-shaped value a warp holds — a 16 x 64 tile of
// S, P, dP or dS — lives in registers in the accumulator layout of the
// tensor cores' mma.m16n8k16: with g = lane / 4 and t = lane % 4,
//   x[n][0], x[n][1] = row g,     columns 8n + 2t, 8n + 2t + 1
//   x[n][2], x[n][3] = row g + 8, the same columns        (n = 0..7).
// Output accumulators [16 rows x D] use the same layout over D / 8 column
// groups. Both products take their operands in that layout:
//   abt: x = A . B^T, A the warp's 16 rows of a shared tile, B a 64-row
//        shared tile, the dot over the first D columns;
//   rb:  acc += round_T(x) . B, x a register tile, B a 64 x D shared tile.
// For bf16 they run on the tensor cores (mma.sync, fp32 accumulation),
// so the dots take bf16 operands and accumulate in fp32, as the TPU
// kernels' dots do; for fp32 they run on the FMA pipes in fp32. In rb the
// register tile is rounded to T first: the TPU kernels' p.astype(v.dtype)
// and ds.astype(k.dtype).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace nezha {
namespace flash {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * WARP;
constexpr int ROWS = 16;              // rows one warp owns
constexpr int TILE = WARPS * ROWS;    // 64: rows a block owns, and streams
constexpr int NT = TILE / 8;          // 8-column groups of a score tile
constexpr int PAD = 8;                // shared row padding, in elements
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == 2 * TILE,
              "the delta pre-pass takes two threads a row");

// Shared row stride of a tile: D + PAD elements. It keeps every row
// 16-byte aligned, spreads the tensor cores' 32-bit fragment loads over
// the banks, and gives a D that is 8 mod 16 the zero columns the last
// 16-deep mma step reads.
__host__ __device__ __forceinline__ int tile_ld(int D) { return D + PAD; }

// The key limit of row b: kv_lengths[b] clamped to [1, Sk] (the TPU
// wrapper's clamp, flash_attention.py:499), or Sk without lengths.
__device__ __forceinline__ int key_limit(const int* lens, int b, int Sk) {
  if (lens == nullptr) return Sk;
  const int n = lens[b];
  return n < 1 ? 1 : (n > Sk ? Sk : n);
}

// Copy rows [row0, row0 + TILE) of a contiguous [n_rows, D] matrix into a
// [TILE][D + PAD] shared tile in 16-byte chunks; rows at or past n_rows
// and the pad columns are zero.
template <typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int row0, int n_rows, int D) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int ld = tile_ld(D);
  const int cpr = ld / VEC;     // chunks per shared row, pad included
  const int src_cpr = D / VEC;  // chunks per source row
#pragma unroll 4
  for (int c = threadIdx.x; c < TILE * cpr; c += THREADS) {
    const int r = c / cpr;
    const int k = c - r * cpr;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (k < src_cpr && row0 + r < n_rows)
      x = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + k * VEC);
    *reinterpret_cast<uint4*>(dst + r * ld + k * VEC) = x;
  }
}

// Half of delta = rowsum(dO * O) for one row in fp32
// (flash_attention.py:223, :239-241): thread `half` of a row's pair sums
// every other 16-byte chunk from chunk `half`, in element order, with
// fmaf(dO, O). The pair's two sums added give the row's delta (the delta
// pre-pass, flash_bwd.cu).
template <typename T>
__device__ __forceinline__ float delta_half(const T* __restrict__ drow,
                                            const T* __restrict__ orow,
                                            int D, int half) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  float sum = 0.f;
  for (int c = half * VEC; c < D; c += 2 * VEC) {
    const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
    const T* op = reinterpret_cast<const T*>(&ov);
    const T* dp = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sum = fmaf(to_float(dp[e]), to_float(op[e]), sum);
  }
  return sum;
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two fp32 values rounded to bf16 (nearest even, as astype does) and
// packed low-then-high, the order of an mma operand register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
struct Mma;

// bf16: tensor cores, fp32 accumulation.
template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;

  static __device__ __forceinline__ void abt(float x[NT][4],
                                             const T* __restrict__ A,
                                             const T* __restrict__ B, int D,
                                             int lane) {
    const int g = lane >> 2, t = lane & 3, ld = tile_ld(D);
#pragma unroll
    for (int n = 0; n < NT; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
    for (int k = 0; k < D; k += 16) {
      uint32_t a[4];
      a[0] = ld32(A + g * ld + k + 2 * t);
      a[1] = ld32(A + (g + 8) * ld + k + 2 * t);
      a[2] = ld32(A + g * ld + k + 8 + 2 * t);
      a[3] = ld32(A + (g + 8) * ld + k + 8 + 2 * t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* b = B + (8 * n + g) * ld + k + 2 * t;
        const uint32_t bb[2] = {ld32(b), ld32(b + 8)};
        mma_bf16(x[n], a, bb);
      }
    }
  }

  template <int ND>
  static __device__ __forceinline__ void rb(float acc[ND][4],
                                            const float x[NT][4],
                                            const T* __restrict__ B, int D,
                                            int lane) {
    const int g = lane >> 2, t = lane & 3, ld = tile_ld(D);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {   // 16 rows of B per mma step
      const uint32_t a[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                             pack_bf16(x[2 * j][2], x[2 * j][3]),
                             pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                             pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
      const T* r = B + (16 * j + 2 * t) * ld + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        if (8 * n < D) {
          const T* c = r + 8 * n;
          const uint32_t b[2] = {pack_raw(c[0], c[ld]),
                                 pack_raw(c[8 * ld], c[9 * ld])};
          mma_bf16(acc[n], a, b);
        }
      }
    }
  }
};

// fp32: the same products and layouts on the FMA pipes.
template <>
struct Mma<float> {
  using T = float;

  static __device__ __forceinline__ void abt(float x[NT][4],
                                             const T* __restrict__ A,
                                             const T* __restrict__ B, int D,
                                             int lane) {
    const int g = lane >> 2, t = lane & 3, ld = tile_ld(D);
#pragma unroll
    for (int n = 0; n < NT; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float a0 = A[g * ld + d];
      const float a1 = A[(g + 8) * ld + d];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float b0 = B[(8 * n + 2 * t) * ld + d];
        const float b1 = B[(8 * n + 2 * t + 1) * ld + d];
        x[n][0] = fmaf(a0, b0, x[n][0]);
        x[n][1] = fmaf(a0, b1, x[n][1]);
        x[n][2] = fmaf(a1, b0, x[n][2]);
        x[n][3] = fmaf(a1, b1, x[n][3]);
      }
    }
  }

  // Each B row j needs x[row][j] of both of this lane's rows: lane
  // 4g + (j % 8) / 2 holds them, so they arrive by shuffle.
  template <int ND>
  static __device__ __forceinline__ void rb(float acc[ND][4],
                                            const float x[NT][4],
                                            const T* __restrict__ B, int D,
                                            int lane) {
    const int t = lane & 3, ld = tile_ld(D);
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const int src = (lane & ~3) | ((j & 7) >> 1);
      const float x0 = __shfl_sync(FULL, x[j >> 3][j & 1], src);
      const float x1 = __shfl_sync(FULL, x[j >> 3][2 + (j & 1)], src);
      const float* row = B + j * ld + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        if (8 * n < D) {
          const float b0 = row[8 * n], b1 = row[8 * n + 1];
          acc[n][0] = fmaf(x0, b0, acc[n][0]);
          acc[n][1] = fmaf(x0, b1, acc[n][1]);
          acc[n][2] = fmaf(x1, b0, acc[n][2]);
          acc[n][3] = fmaf(x1, b1, acc[n][3]);
        }
      }
    }
  }
};

// Row r0 + {0, 8} of the register layout: which of a lane's two rows
// element e (0..3) of x[n] belongs to, and its column within the tile.
__device__ __forceinline__ int frag_row(int e) { return e >> 1; }
__device__ __forceinline__ int frag_col(int n, int e, int lane) {
  return 8 * n + 2 * (lane & 3) + (e & 1);
}

// Write a [16 x D] register accumulator of the warp's rows r0 and
// r0 + 8 to out (row stride D) divided by den[0] / den[1], rounded to T;
// rows at or past n_rows are skipped.
template <typename T, int ND>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const float acc[ND][4], int r0,
                                           int n_rows, int D, int lane,
                                           float den0, float den1) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (8 * n >= D) continue;
    const int c = 8 * n + 2 * t;
    if (r0 < n_rows) {
      T* p = out + static_cast<size_t>(r0) * D + c;
      p[0] = from_float<T>(acc[n][0] / den0);
      p[1] = from_float<T>(acc[n][1] / den0);
    }
    if (r0 + 8 < n_rows) {
      T* p = out + static_cast<size_t>(r0 + 8) * D + c;
      p[0] = from_float<T>(acc[n][2] / den1);
      p[1] = from_float<T>(acc[n][3] / den1);
    }
  }
}

// A kernel's launch geometry as the caller decided it (ops/cuda/
// flash_attention.py FlashPlan.as_c, six ints in this order): the head
// dim its tiles hold (D padded), the rows a block owns, the rows of a
// streamed tile, the stages of the ring, the dynamic shared bytes, and
// whether the grid launches the heaviest tiles first. The entry points
// launch only a body whose geometry it matches, and fail otherwise.
struct Plan {
  int d_pad, rows, tile, stages, smem, heavy_first;

  bool matches(int d_pad_, int rows_, int tile_, int stages_,
               size_t smem_) const {
    return d_pad == d_pad_ && rows == rows_ && tile == tile_ &&
           stages == stages_ && static_cast<size_t>(smem) == smem_ &&
           (heavy_first == 0 || heavy_first == 1);
  }
};

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x on the special-function unit (ex2.approx.ftz: ~2 ulp, results
// below 2^-126 flushed to zero), the exponential of the Hopper bodies,
// which run the softmax in base 2. Against expf of the same argument a
// p differs by ~2^-22 of itself, far below the bf16 rounding (2^-8) it
// then takes before each product.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// store_rows for bf16 outputs of the Hopper bodies: each column pair
// (acc / den, rounded to nearest even) in one 4-byte store.
template <int ND>
__device__ __forceinline__ void store_rows_bf16x2(
    __nv_bfloat16* __restrict__ out, const float acc[ND][4], int r0,
    int n_rows, int D, int lane, float den0, float den1) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (8 * n >= D) continue;
    const int c = 8 * n + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r0) * D +
                                         c) =
          __floats2bfloat162_rn(acc[n][0] / den0, acc[n][1] / den0);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(r0 + 8) * D + c) =
          __floats2bfloat162_rn(acc[n][2] / den1, acc[n][3] / den1);
  }
}

// Opt into the dynamic shared memory of one kernel and check the launch
// fits: at most 227 KB a block on sm_90.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  return allow_smem(kernel, smem);
}

}  // namespace flash
}  // namespace nezha
