// Fused LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces: nezha_tpu/ops/pallas/layer_norm.py:_ln_kernel (forward) and
// :_ln_bwd_kernel (backward, the custom VJP's), reached from nn/layers.py
// LayerNorm(impl="pallas") — GPT-2's ln_1, ln_2 and ln_f when the model is
// built with ln_impl="pallas".
//
// Computes, for x [rows, D] (f32 or bf16) and fp32 scale/bias [D]:
//   forward:  mean = sum(x)/D, var = sum((x - mean)^2)/D (two passes over
//             the row held in registers, never E[x^2] - mean^2),
//             y = (x - mean) * rsqrt(var + eps) * scale + bias, in fp32,
//             stored in x's dtype;
//   backward: the statistics recomputed from x, xhat = (x - mean) * r,
//             g = dy * scale, dx = r * (g - sum(g)/D - xhat * sum(g*xhat)/D)
//             in x's dtype, and per-row-block fp32 partials of
//             dscale = sum_rows dy * xhat and dbias = sum_rows dy, one row
//             of [n_blocks, D] per thread block, summed by the caller.
//
// What bounds it: bytes. The forward reads x and writes y (4 bytes per bf16
// element) and does ~8 flops per element; the backward reads x and dy and
// writes dx. Both are row-local, so the design reads each element once:
//   - one warp per row; a lane holds the row's elements in registers in
//     16-byte chunks (chunk lane, lane + 32, ...), so the second pass and
//     the affine step never re-read x;
//   - a fixed summation order: each lane sums its own elements in chunk
//     order, then a butterfly shuffle whose every step adds the same two
//     values on both lanes, so every lane holds the same, repeatable sum;
//   - the backward's dscale/dbias partials: each warp accumulates its rows
//     (rows w, w + 8, ... of the block's LN_BWD_ROWS) in registers, and the
//     warps' partials are added in warp order through shared memory. No
//     atomics anywhere: both kernels are bitwise repeatable.
// The forward is shaped for the rows the card gets: 8 a launch in
// generate's decode steps (almost all of its launches), 4096 in its
// prefill, 8192 in a train step. A lane holds exactly its CPL chunks of
// the row, CPL a compile-time count (1-4 for bf16, 1-8 for f32), so no
// register holds padding past D. Its grid is planned in Python
// (ops/cuda/layer_norm.py fwd_plan) and checked here (fwd_plan_ok):
//   - few rows: a block of one warp per row, so the rows spread over SMs,
//     and a lane issues its x chunks and its scale and bias loads before
//     the first reduction: one memory round trip on the chain, not two;
//   - many rows: a persistent grid of 8-warp blocks whose warps stride
//     over the rows, scale and bias loaded once per warp and kept in
//     registers, and the next row's x loaded into a second register
//     buffer before this row's reductions run.
// The backward (a warp per row in blocks of LN_BWD_ROWS, its rows held in
// LN_VALS registers a lane) is unchanged by that redesign.
// D must be a multiple of 8 (16-byte chunks of bf16) and at most LN_MAX_D,
// so a lane never holds more than 32 values of a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "online_softmax.cuh"   // to_float / from_float, warp_sum, DType

namespace nezha {
namespace {

constexpr int LN_WARPS = 8;       // rows in flight per backward block
// Warps of a many-rows forward block (ops/cuda/layer_norm.py
// FWD_MANY_WARPS), the forward's launch bound.
constexpr int LN_FWD_WARPS = 8;
constexpr int LN_MAX_D = 1024;
constexpr int LN_BWD_ROWS = 32;   // rows per backward block (one partial)
constexpr int LN_VALS = LN_MAX_D / WARP;   // values of a row per lane

// A lane's share of one row: chunk j of the lane is chunk lane + 32 j of
// the row, VEC = 16 / sizeof(T) elements; chunks past the row read as 0.
template <typename T>
struct RowSlice {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int CHUNKS = LN_VALS / VEC;
  float v[LN_VALS];

  __device__ __forceinline__ void load(const T* __restrict__ row, int cpr,
                                       int lane) {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int c = lane + j * WARP;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (c < cpr) raw = *reinterpret_cast<const uint4*>(row + c * VEC);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[j * VEC + e] = to_float(t[e]);
    }
  }

  __device__ __forceinline__ void store(T* __restrict__ row, int cpr,
                                        int lane) const {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int c = lane + j * WARP;
      if (c >= cpr) continue;
      uint4 raw;
      T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = from_float<T>(v[j * VEC + e]);
      *reinterpret_cast<uint4*>(row + c * VEC) = raw;
    }
  }
};

// Per-lane copy of a [D] fp32 vector laid out like RowSlice<T>.
template <typename T>
__device__ __forceinline__ void load_params(float* out,
                                            const float* __restrict__ p,
                                            int cpr, int lane) {
  constexpr int VEC = RowSlice<T>::VEC;
#pragma unroll
  for (int j = 0; j < RowSlice<T>::CHUNKS; ++j) {
    const int c = lane + j * WARP;
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < cpr) f = *reinterpret_cast<const float4*>(p + c * VEC + e);
      out[j * VEC + e] = f.x;
      out[j * VEC + e + 1] = f.y;
      out[j * VEC + e + 2] = f.z;
      out[j * VEC + e + 3] = f.w;
    }
  }
}

// Two-pass fp32 statistics of the row a warp holds: -> (mean, rsqrt(var +
// eps)). Padding values are 0 and are left out of the second pass.
template <typename T>
__device__ __forceinline__ float2 row_stats(const RowSlice<T>& x, int cpr,
                                            int D, int lane, float eps) {
  constexpr int VEC = RowSlice<T>::VEC;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_VALS; ++i) s += x.v[i];
  const float mean = warp_sum(s) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < LN_VALS; ++i) {
    const float d = x.v[i] - mean;
    if (lane + (i / VEC) * WARP < cpr) sq += d * d;
  }
  const float var = warp_sum(sq) / D;
  return make_float2(mean, rsqrtf(var + eps));
}

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

// One [D] partial of a backward block: every warp puts its register sums
// in its row of `part` [LN_WARPS][D], then each column is added in warp
// order. Called by all threads of the block.
template <int VEC>
__device__ __forceinline__ void write_partial(float* part,
                                              const float (&mine)[LN_VALS],
                                              float* __restrict__ dst, int D,
                                              int warp, int lane) {
#pragma unroll
  for (int j = 0; j < LN_VALS; ++j) {
    const int col = (lane + (j / VEC) * WARP) * VEC + j % VEC;
    if (col < D) part[warp * D + col] = mine[j];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < D; col += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < LN_WARPS; ++w) acc += part[w * D + col];
    dst[col] = acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(LN_WARPS * WARP)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ dscale_part,
                  float* __restrict__ dbias_part, int rows, int D,
                  float eps) {
  extern __shared__ float part[];   // [LN_WARPS][D]
  constexpr int VEC = RowSlice<T>::VEC;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int cpr = D / VEC;
  float sc[LN_VALS], ds[LN_VALS], db[LN_VALS];
  load_params<T>(sc, scale, cpr, lane);
#pragma unroll
  for (int i = 0; i < LN_VALS; ++i) ds[i] = db[i] = 0.f;

  const int first = blockIdx.x * LN_BWD_ROWS;
  for (int i = warp; i < LN_BWD_ROWS && first + i < rows; i += LN_WARPS) {
    const size_t off = static_cast<size_t>(first + i) * D;
    RowSlice<T> xs, gs;
    xs.load(x + off, cpr, lane);
    gs.load(dy + off, cpr, lane);
    const float2 st = row_stats(xs, cpr, D, lane, eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < LN_VALS; ++j) {
      // Past the row dy and scale read 0, so padding adds nothing.
      const float xh = (xs.v[j] - st.x) * st.y;
      const float g = gs.v[j] * sc[j];
      ds[j] += gs.v[j] * xh;
      db[j] += gs.v[j];
      xs.v[j] = xh;
      s1 += g;
      s2 += g * xh;
    }
    const float m1 = warp_sum(s1) / D;
    const float m2 = warp_sum(s2) / D;
#pragma unroll
    for (int j = 0; j < LN_VALS; ++j) {
      const float g = gs.v[j] * sc[j];
      gs.v[j] = st.y * (g - m1 - xs.v[j] * m2);
    }
    gs.store(dx + off, cpr, lane);
  }

  // The block's partials: the warps' sums added in warp order.
  write_partial<VEC>(part, ds, dscale_part + static_cast<size_t>(blockIdx.x) * D,
                     D, warp, lane);
  write_partial<VEC>(part, db, dbias_part + static_cast<size_t>(blockIdx.x) * D,
                     D, warp, lane);
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

template <typename T>
cudaError_t launch_bwd(const void* x, const float* scale, const void* dy,
                       void* dx, float* dscale_part, float* dbias_part,
                       int rows, int D, float eps, cudaStream_t stream) {
  const int blocks = (rows + LN_BWD_ROWS - 1) / LN_BWD_ROWS;
  const size_t smem = sizeof(float) * LN_WARPS * D;   // <= 32 KB
  ln_bwd_kernel<T><<<blocks, LN_WARPS * WARP, smem, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy),
      static_cast<T*>(dx), dscale_part, dbias_part, rows, D, eps);
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

// x, dy, dx [rows, D] of one dtype; scale [D] fp32; dscale_part and
// dbias_part [ceil(rows / 32), D] fp32, one row per thread block.
extern "C" int nezha_layer_norm_bwd(const void* x, const void* scale,
                                    const void* dy, void* dx,
                                    void* dscale_part, void* dbias_part,
                                    int rows, int D, float eps, int x_dtype,
                                    void* stream) {
  if (nezha::bad_shape(rows, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  float* dsp = static_cast<float*>(dscale_part);
  float* dbp = static_cast<float*>(dbias_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  if (x_dtype == nezha::BF16)
    return nezha::launch_bwd<__nv_bfloat16>(x, s, dy, dx, dsp, dbp, rows, D,
                                            eps, st);
  if (x_dtype == nezha::F32)
    return nezha::launch_bwd<float>(x, s, dy, dx, dsp, dbp, rows, D, eps,
                                    st);
  return static_cast<int>(cudaErrorInvalidValue);
}
