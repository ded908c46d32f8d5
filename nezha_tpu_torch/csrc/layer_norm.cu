// Fused LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces: nezha_tpu/ops/pallas/layer_norm.py:_ln_kernel (forward) and
// :_ln_bwd_kernel (backward, the custom VJP's, with the sums of its
// per-block partials the VJP takes outside the kernel), reached from
// nn/layers.py LayerNorm(impl="pallas") — GPT-2's ln_1, ln_2 and ln_f when
// the model is built with ln_impl="pallas".
//
// Computes, for x [rows, D] (f32 or bf16) and fp32 scale/bias [D]:
//   forward:  mean = sum(x)/D, var = sum((x - mean)^2)/D (two passes over
//             the row held in registers, never E[x^2] - mean^2),
//             y = (x - mean) * rsqrt(var + eps) * scale + bias, in fp32,
//             stored in x's dtype;
//   backward: the statistics recomputed from x, xhat = (x - mean) * r,
//             g = dy * scale, dx = r * (g - sum(g)/D - xhat * sum(g*xhat)/D)
//             in x's dtype, and dscale = sum_rows dy * xhat and dbias =
//             sum_rows dy in fp32 [D].
//
// What bounds it: bytes. The forward reads x and writes y (4 bytes per bf16
// element) and does ~8 flops per element; the backward reads x and dy and
// writes dx (6 bytes) and does ~19. Both are row-local, so the design reads
// each element once:
//   - a warp per row; a lane holds exactly its CPL 16-byte chunks of the
//     row (chunk lane, lane + 32, ...; CPL a compile-time count, 1-4 for
//     bf16 and 1-8 for f32, a build of each), so the second pass and the
//     affine step never re-read x and no register holds padding past D;
//   - a fixed summation order: each lane sums its own elements in chunk
//     order, then a butterfly shuffle whose every step adds the same two
//     values on both lanes, so every lane holds the same, repeatable sum;
//   - a persistent grid whose warps stride over the rows, keeping scale
//     (and bias) in registers for every row they take and loading the
//     next row before this row's reductions run.
// Both grids are planned in Python (ops/cuda/layer_norm.py fwd_plan,
// bwd_plan) and checked here (fwd_plan_ok, bwd_plan_ok); the entry points
// refuse any other geometry.
//
// The forward is shaped for the rows the card gets: 8 a launch in
// generate's decode steps (almost all of its launches), 4096 in its
// prefill, 8192 in a train step:
//   - few rows: a block of one warp per row, so the rows spread over SMs,
//     and a lane issues its x chunks and its scale and bias loads before
//     the first reduction: one memory round trip on the chain, not two;
//   - many rows: a persistent grid of 8-warp blocks, the next row's x
//     loaded into a second register buffer.
// The backward gets 8192 rows a call (a train step's) and is two
// launches:
//   - a persistent grid of LN_BWD_WARPS-warp blocks, at most
//     LN_BWD_BLOCKS_PER_SM (two) an SM, every block resident at once. A
//     lane's registers hold only its rows' x and dy (this row's, and the
//     next row's, loaded before this row's reductions); scale sits in
//     shared memory, and each warp adds dy * xhat and dy of its rows into
//     a row of shared memory of its own, so two blocks fit an SM. The
//     statistics and sum(g) share the first reduction round, so a row
//     takes three rounds, not four. The rows' kernel reaches ~57% of the
//     memory rate at 8192 x 768 on the H100; one block an SM with scale
//     and the sums in registers timed the same, and this layout at one
//     block an SM slower (PERF.md), so what holds it is not yet known;
//   - a block adds its warps' sums in warp order into one fp32 partial
//     [2][D] in a workspace; then ln_bwd_sums_kernel sums slabs of
//     LN_SLAB columns over the blocks' partials, a block a slab: each
//     range of its threads adds a contiguous range of blocks in block
//     order, then the ranges are added in order. No atomic touches data:
//     the backward is bitwise repeatable. (The same sums in the rows'
//     launch, after a grid-wide barrier of a cooperative launch, timed
//     0.5 us slower on the H100: PERF.md.)
// D must be a multiple of 8 (16-byte chunks of bf16) and at most LN_MAX_D.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "online_softmax.cuh"   // to_float / from_float, warp_sum, DType

namespace nezha {
namespace {

// Warps of a many-rows forward block (ops/cuda/layer_norm.py
// FWD_MANY_WARPS), the forward's launch bound.
constexpr int LN_FWD_WARPS = 8;
// Warps of a backward block and backward blocks an SM (ops/cuda/
// layer_norm.py BWD_WARPS, BWD_BLOCKS_PER_SM), the backward's launch
// bounds.
constexpr int LN_BWD_WARPS = 8;
constexpr int LN_BWD_BLOCKS_PER_SM = 2;
// A backward warp loads its next row's x and dy before this row's
// reductions where a lane holds at most this many 16-byte chunks of a
// row (every bf16 width; f32 up to D=512), so the registers stay within
// LN_BWD_BLOCKS_PER_SM's bound.
constexpr int LN_BWD_AHEAD_CPL = 4;
// Columns a backward block sums at a time (a 32-byte sector of fp32).
constexpr int LN_SLAB = 8;
constexpr int LN_MAX_D = 1024;

// ------------------------------------------------------------ the forward
// A lane's CPL 16-byte chunks of one row, raw (chunk j of the lane is
// chunk lane + 32 j of the row; chunks past the row read as 0). CPL is a
// compile-time count, so a lane holds exactly its share of the row.
template <typename T, int CPL>
struct RowChunks {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int N = CPL * VEC;   // values a lane holds
  uint4 raw[CPL];

  __device__ __forceinline__ void load(const T* __restrict__ row, int cpr,
                                       int lane) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + j * WARP;
      raw[j] = c < cpr ? *reinterpret_cast<const uint4*>(row + c * VEC)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ float at(int i) const {
    return to_float(reinterpret_cast<const T*>(raw)[i]);
  }
};

// A lane's values of a [D] fp32 vector, laid out like RowChunks<T, CPL>.
template <typename T, int CPL>
__device__ __forceinline__ void load_param_chunks(
    float (&out)[RowChunks<T, CPL>::N], const float* __restrict__ p, int cpr,
    int lane) {
  constexpr int VEC = RowChunks<T, CPL>::VEC;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + j * WARP;
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 f =
          c < cpr ? *reinterpret_cast<const float4*>(p + c * VEC + e)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      out[j * VEC + e] = f.x;
      out[j * VEC + e + 1] = f.y;
      out[j * VEC + e + 2] = f.z;
      out[j * VEC + e + 3] = f.w;
    }
  }
}

// A warp per row; the warps of the grid stride over the rows (row w, w +
// gridDim.x * warps, ...). Before its first row a lane issues the row's x
// chunks and its scale and bias values together, and keeps scale and bias
// in registers for every row it takes; before a row's reductions it issues
// the next row's x into a second buffer.
template <typename T, int CPL>
__global__ void __launch_bounds__(LN_FWD_WARPS * WARP)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int rows,
                  int D, float eps) {
  using Row = RowChunks<T, CPL>;
  constexpr int VEC = Row::VEC;
  constexpr int N = Row::N;
  const int lane = threadIdx.x % WARP;
  const int warps = blockDim.x / WARP;
  const int stride = gridDim.x * warps;
  int row = blockIdx.x * warps + threadIdx.x / WARP;
  if (row >= rows) return;
  const int cpr = D / VEC;
  Row cur;
  cur.load(x + static_cast<size_t>(row) * D, cpr, lane);
  float sc[N], bi[N];
  load_param_chunks<T, CPL>(sc, scale, cpr, lane);
  load_param_chunks<T, CPL>(bi, bias, cpr, lane);
  while (true) {
    const int next = row + stride;
    Row nxt;
    if (next < rows) nxt.load(x + static_cast<size_t>(next) * D, cpr, lane);
    // Two-pass fp32 statistics: the zeros past the row add nothing to the
    // sum and are left out of the second pass.
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) s += cur.at(i);
    const float mean = warp_sum(s) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d = cur.at(i) - mean;
      if (lane + (i / VEC) * WARP < cpr) sq += d * d;
    }
    const float r = rsqrtf(warp_sum(sq) / D + eps);
    T* yr = y + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + j * WARP;
      if (c >= cpr) continue;
      uint4 raw;
      T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int i = j * VEC + e;
        t[e] = from_float<T>((cur.at(i) - mean) * r * sc[i] + bi[i]);
      }
      *reinterpret_cast<uint4*>(yr + c * VEC) = raw;
    }
    if (next >= rows) break;
    row = next;
    cur = nxt;
  }
}

// ----------------------------------------------------------- the backward
// Dynamic shared memory of a backward block: scale [D], then each warp's
// sums of dy * xhat and of dy over its rows, [LN_BWD_WARPS][D] each.
inline size_t bwd_smem_bytes(int D) {
  return sizeof(float) * D * (1 + 2 * LN_BWD_WARPS);
}

// One [D] partial of a backward block into dst: the warps' rows of
// sums [LN_BWD_WARPS][D] added column by column in warp order. Called by
// all threads of the block after a __syncthreads.
__device__ __forceinline__ void block_partial(const float* warp_sums,
                                              float* __restrict__ dst,
                                              int D) {
  for (int col = threadIdx.x; col < D; col += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < LN_BWD_WARPS; ++w) acc += warp_sums[w * D + col];
    dst[col] = acc;
  }
}

// A lane's VEC values of 16-byte chunk c of an fp32 [D] row in shared
// memory (zeros past the row's cpr chunks).
template <int VEC>
__device__ __forceinline__ void smem_chunk(float (&out)[VEC],
                                           const float* row, int c,
                                           int cpr) {
#pragma unroll
  for (int e = 0; e < VEC; e += 4) {
    const float4 f = c < cpr
                         ? *reinterpret_cast<const float4*>(row + c * VEC + e)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    out[e] = f.x;
    out[e + 1] = f.y;
    out[e + 2] = f.z;
    out[e + 3] = f.w;
  }
}

// Add a lane's VEC values to 16-byte chunk c (< cpr) of an fp32 row in
// shared memory.
template <int VEC>
__device__ __forceinline__ void smem_chunk_add(float* row, int c,
                                               const float (&add)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; e += 4) {
    float4* f = reinterpret_cast<float4*>(row + c * VEC + e);
    float4 v = *f;
    v.x += add[e];
    v.y += add[e + 1];
    v.z += add[e + 2];
    v.w += add[e + 3];
    *f = v;
  }
}

// A warp per row; the grid's warps stride over the rows (row w, w +
// gridDim.x * LN_BWD_WARPS, ...). The block keeps scale in shared memory
// and each warp its sums of dy * xhat and dy over its rows (a row of
// shared memory each, so a lane's registers hold little more than its
// rows' x and dy, and LN_BWD_BLOCKS_PER_SM blocks fit an SM); before a
// row's reductions a lane issues the x and dy of its row AHEAD rows on.
// Then the block's partial of the column sums.
template <typename T, int CPL>
__global__ void __launch_bounds__(LN_BWD_WARPS * WARP, LN_BWD_BLOCKS_PER_SM)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ parts, int rows, int D, float eps) {
  using Row = RowChunks<T, CPL>;
  constexpr int VEC = Row::VEC;
  constexpr int N = Row::N;
  constexpr int AHEAD = CPL <= LN_BWD_AHEAD_CPL ? 1 : 0;
  extern __shared__ __align__(16) float bwd_sm[];
  float* sc_sm = bwd_sm;                          // [D]
  float* ds_sm = bwd_sm + D;                      // [LN_BWD_WARPS][D]
  float* db_sm = ds_sm + LN_BWD_WARPS * D;        // [LN_BWD_WARPS][D]
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int cpr = D / VEC;
  const int stride = gridDim.x * LN_BWD_WARPS;
  float* my_ds = ds_sm + warp * D;
  float* my_db = db_sm + warp * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) sc_sm[i] = scale[i];
  for (int i = lane; i < D; i += WARP) my_ds[i] = my_db[i] = 0.f;
  __syncthreads();

  int row = blockIdx.x * LN_BWD_WARPS + warp;
  if (row < rows) {
    // xs[k], gs[k]: x and dy of the row k strides on; [0] is reduced.
    Row xs[AHEAD + 1], gs[AHEAD + 1];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const int r = row + k * stride;
      if (r < rows) {
        xs[k].load(x + static_cast<size_t>(r) * D, cpr, lane);
        gs[k].load(dy + static_cast<size_t>(r) * D, cpr, lane);
      }
    }
    while (true) {
      const int ahead = row + AHEAD * stride;
      if (ahead < rows) {
        xs[AHEAD].load(x + static_cast<size_t>(ahead) * D, cpr, lane);
        gs[AHEAD].load(dy + static_cast<size_t>(ahead) * D, cpr, lane);
      }
      const Row& xc = xs[0];
      const Row& gc = gs[0];
      // Round 1: sum(x) and sum(g), g = dy * scale (zero past the row).
      float s = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        float sv[VEC];
        smem_chunk<VEC>(sv, sc_sm, lane + j * WARP, cpr);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          s += xc.at(j * VEC + e);
          s1 += gc.at(j * VEC + e) * sv[e];
        }
      }
      const float mean = warp_sum(s) / D;
      const float m1 = warp_sum(s1) / D;
      // Round 2: the variance, the padding left out.
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float d = xc.at(i) - mean;
        if (lane + (i / VEC) * WARP < cpr) sq += d * d;
      }
      const float r = rsqrtf(warp_sum(sq) / D + eps);
      // Round 3: sum(g * xhat), and the warp's column sums of dy * xhat
      // and dy.
      float s2 = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + j * WARP;
        float sv[VEC], dsv[VEC], dbv[VEC];
        smem_chunk<VEC>(sv, sc_sm, c, cpr);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = (xc.at(j * VEC + e) - mean) * r;
          const float g = gc.at(j * VEC + e);
          dsv[e] = g * xh;
          dbv[e] = g;
          s2 += g * sv[e] * xh;
        }
        if (c < cpr) {
          smem_chunk_add<VEC>(my_ds, c, dsv);
          smem_chunk_add<VEC>(my_db, c, dbv);
        }
      }
      const float m2 = warp_sum(s2) / D;
      T* dxr = dx + static_cast<size_t>(row) * D;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + j * WARP;
        if (c >= cpr) continue;
        float sv[VEC];
        smem_chunk<VEC>(sv, sc_sm, c, cpr);
        uint4 raw;
        T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = j * VEC + e;
          const float xh = (xc.at(i) - mean) * r;
          t[e] = from_float<T>(r * (gc.at(i) * sv[e] - m1 - xh * m2));
        }
        *reinterpret_cast<uint4*>(dxr + c * VEC) = raw;
      }
      row += stride;
      if (row >= rows) break;
#pragma unroll
      for (int k = 0; k < AHEAD; ++k) {
        xs[k] = xs[k + 1];
        gs[k] = gs[k + 1];
      }
    }
  }

  // The block's partial [2][D]: its warps' sums added in warp order.
  __syncthreads();
  block_partial(ds_sm, parts + static_cast<size_t>(blockIdx.x) * D, D);
  block_partial(db_sm,
                parts + (static_cast<size_t>(gridDim.x) + blockIdx.x) * D, D);
}

// The column sums, after ln_bwd_kernel on the same stream: block i sums
// slab i of LN_SLAB columns of the 2D columns (dscale's D, then dbias's)
// over the `blocks` fp32 partials [2][blocks][D]. Its threads form R
// ranges of LN_SLAB; range r adds the partials of its contiguous range
// of blocks in block order, then the first LN_SLAB threads add the
// ranges' sums in range order.
__global__ void __launch_bounds__(LN_BWD_WARPS * WARP)
    ln_bwd_sums_kernel(const float* __restrict__ parts, int blocks, int D,
                       float* __restrict__ dscale,
                       float* __restrict__ dbias) {
  constexpr int R = LN_BWD_WARPS * WARP / LN_SLAB;
  __shared__ float red[LN_BWD_WARPS * WARP];
  const int k = threadIdx.x % LN_SLAB, range = threadIdx.x / LN_SLAB;
  const int lo = range * blocks / R, hi = (range + 1) * blocks / R;
  const int col = blockIdx.x * LN_SLAB + k;   // of the 2D columns
  float acc = 0.f;
  if (col < 2 * D) {
    const int which = col >= D, c = col - which * D;
    const float* p = parts + static_cast<size_t>(which) * blocks * D + c;
#pragma unroll 8
    for (int blk = lo; blk < hi; ++blk)
      acc += __ldcg(p + static_cast<size_t>(blk) * D);
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  if (range == 0 && col < 2 * D) {
    float sum = red[k];
#pragma unroll 8
    for (int r = 1; r < R; ++r) sum += red[r * LN_SLAB + k];
    if (col < D)
      dscale[col] = sum;
    else
      dbias[col - D] = sum;
  }
}

// The forward built for CPL chunks a lane, or the next smaller build down
// to 1; a cpl no build holds is refused.
template <typename T, int CPL>
cudaError_t launch_fwd(const void* x, const float* scale, const float* bias,
                       void* y, int rows, int D, float eps, int cpl,
                       int warps, int blocks, cudaStream_t stream) {
  if (cpl == CPL) {
    ln_fwd_kernel<T, CPL><<<blocks, warps * WARP, 0, stream>>>(
        static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, D,
        eps);
    return cudaGetLastError();
  }
  if constexpr (CPL > 1)
    return launch_fwd<T, CPL - 1>(x, scale, bias, y, rows, D, eps, cpl,
                                  warps, blocks, stream);
  return cudaErrorInvalidValue;
}

// The chunks a lane holds at the widest row, LN_MAX_D: 4 for bf16, 8 for
// f32. Every smaller count is built too.
template <typename T>
constexpr int max_cpl() {
  return LN_MAX_D / (16 / static_cast<int>(sizeof(T))) / WARP;
}

// Many-rows forward blocks an SM (ops/cuda/layer_norm.py
// FWD_BLOCKS_PER_SM).
constexpr int LN_FWD_BLOCKS_PER_SM = 2;

// SMs of the current device, read once per device; 0 if unknown.
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

// The forward's plan (ops/cuda/layer_norm.py fwd_plan, restated): a
// lane's chunks those of the row; up to one row per SM, a one-warp block
// a row; more rows, LN_FWD_WARPS-warp blocks, as many as give every
// warp the same rows up to one at LN_FWD_BLOCKS_PER_SM blocks an SM.
bool fwd_plan_ok(int rows, int D, int elem_bytes, int cpl, int warps,
                 int blocks) {
  const int cpr = D / (16 / elem_bytes);
  if (cpl != (cpr + WARP - 1) / WARP) return false;
  const int sms = sm_count();
  if (sms <= 0) return false;
  if (rows <= sms) return warps == 1 && blocks == rows;
  const int slots = sms * LN_FWD_BLOCKS_PER_SM * LN_FWD_WARPS;
  const int per_warp = (rows + slots - 1) / slots;
  const int row_warps = (rows + per_warp - 1) / per_warp;
  return warps == LN_FWD_WARPS &&
         blocks == (row_warps + LN_FWD_WARPS - 1) / LN_FWD_WARPS;
}

// The plan of the forward's last launch from this library (cpl, warps,
// blocks), for a caller that reports what ran.
int last_fwd_plan[3] = {0, 0, 0};

// The backward's plan (ops/cuda/layer_norm.py bwd_plan, restated): a
// lane's chunks those of the row; LN_BWD_WARPS-warp blocks, as many as
// the rows fill, at most LN_BWD_BLOCKS_PER_SM an SM, so every warp takes
// the same rows up to one and the partials stay one a resident block.
bool bwd_plan_ok(int rows, int D, int elem_bytes, int cpl, int warps,
                 int blocks) {
  const int cpr = D / (16 / elem_bytes);
  if (cpl != (cpr + WARP - 1) / WARP) return false;
  const int sms = sm_count();
  if (sms <= 0) return false;
  const int fill = (rows + LN_BWD_WARPS - 1) / LN_BWD_WARPS;
  const int most = sms * LN_BWD_BLOCKS_PER_SM;
  return warps == LN_BWD_WARPS && blocks == (fill < most ? fill : most);
}

// The backward built for CPL chunks a lane, or the next smaller build
// down to 1: the rows' kernel and then the sums kernel.
template <typename T, int CPL>
cudaError_t launch_bwd(const void* x, const float* scale, const void* dy,
                       void* dx, float* dscale, float* dbias, float* parts,
                       int rows, int D, float eps, int cpl, int blocks,
                       cudaStream_t stream) {
  if (cpl != CPL) {
    if constexpr (CPL > 1)
      return launch_bwd<T, CPL - 1>(x, scale, dy, dx, dscale, dbias, parts,
                                    rows, D, eps, cpl, blocks, stream);
    return cudaErrorInvalidValue;
  }
  const size_t smem = bwd_smem_bytes(D);   // 68 KB at D = 1024
  auto kernel = ln_bwd_kernel<T, CPL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, LN_BWD_WARPS * WARP, smem, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy),
      static_cast<T*>(dx), parts, rows, D, eps);
  const int slabs = (2 * D + LN_SLAB - 1) / LN_SLAB;
  ln_bwd_sums_kernel<<<slabs, LN_BWD_WARPS * WARP, 0, stream>>>(
      parts, blocks, D, dscale, dbias);
  return cudaGetLastError();
}

bool bad_shape(int rows, int D) {
  return rows <= 0 || D <= 0 || D > LN_MAX_D || D % 8;
}

}  // namespace
}  // namespace nezha

// x, y [rows, D] of one dtype (x_dtype: 0 f32, 1 bf16); scale, bias [D]
// fp32. Contiguous, 16-byte aligned, on the current device. The plan:
// cpl 16-byte chunks a lane, warps a block, blocks; any plan but
// fwd_plan_ok's is refused. Returns the cudaError_t of the launch (0 =
// queued).
extern "C" int nezha_layer_norm_fwd(const void* x, const void* scale,
                                    const void* bias, void* y, int rows,
                                    int D, float eps, int x_dtype,
                                    void* stream, int cpl, int warps,
                                    int blocks) {
  using nezha::max_cpl;
  if (nezha::bad_shape(rows, D) || (x_dtype != nezha::BF16 &&
                                    x_dtype != nezha::F32) ||
      !nezha::fwd_plan_ok(rows, D, x_dtype == nezha::BF16 ? 2 : 4, cpl,
                          warps, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  const cudaError_t err =
      x_dtype == nezha::BF16
          ? nezha::launch_fwd<__nv_bfloat16, max_cpl<__nv_bfloat16>()>(
                x, s, b, y, rows, D, eps, cpl, warps, blocks, st)
          : nezha::launch_fwd<float, max_cpl<float>()>(
                x, s, b, y, rows, D, eps, cpl, warps, blocks, st);
  if (err == cudaSuccess) {
    nezha::last_fwd_plan[0] = cpl;
    nezha::last_fwd_plan[1] = warps;
    nezha::last_fwd_plan[2] = blocks;
  }
  return static_cast<int>(err);
}

// Writes the plan (cpl, warps, blocks) of the last forward
// nezha_layer_norm_fwd launched into out[3]; zeros before the first.
// Returns 0.
extern "C" int nezha_layer_norm_fwd_last_plan(int* out) {
  for (int i = 0; i < 3; ++i) out[i] = nezha::last_fwd_plan[i];
  return 0;
}

// x, dy, dx [rows, D] of one dtype (x_dtype: 0 f32, 1 bf16); scale [D]
// fp32; dscale and dbias [D] fp32, written. Contiguous, 16-byte aligned,
// on the current device. The plan: cpl 16-byte chunks a lane, warps a
// block, blocks; any plan but bwd_plan_ok's is refused. parts: fp32
// workspace of 2 * blocks * D floats. Calls that share the workspace
// must run in order (one stream). Returns the cudaError_t of the launches
// (0 = queued).
extern "C" int nezha_layer_norm_bwd(const void* x, const void* scale,
                                    const void* dy, void* dx, void* dscale,
                                    void* dbias, int rows, int D, float eps,
                                    int x_dtype, void* stream, int cpl,
                                    int warps, int blocks, void* parts) {
  using nezha::max_cpl;
  if (nezha::bad_shape(rows, D) || (x_dtype != nezha::BF16 &&
                                    x_dtype != nezha::F32) ||
      parts == nullptr ||
      !nezha::bwd_plan_ok(rows, D, x_dtype == nezha::BF16 ? 2 : 4, cpl,
                          warps, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  float* p = static_cast<float*>(parts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  return static_cast<int>(
      x_dtype == nezha::BF16
          ? nezha::launch_bwd<__nv_bfloat16, max_cpl<__nv_bfloat16>()>(
                x, s, dy, dx, ds, db, p, rows, D, eps, cpl, blocks, st)
          : nezha::launch_bwd<float, max_cpl<float>()>(
                x, s, dy, dx, ds, db, p, rows, D, eps, cpl, blocks, st));
}
