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
//     atomics anywhere: the backward is bitwise repeatable.
// D must be a multiple of 8 (16-byte chunks of bf16) and at most LN_MAX_D,
// so a lane never holds more than 32 values of a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "online_softmax.cuh"   // to_float / from_float, warp_sum, DType

namespace nezha {
namespace {

constexpr int LN_WARPS = 8;       // rows in flight per thread block
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

template <typename T>
__global__ void __launch_bounds__(LN_WARPS * WARP)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int rows,
                  int D, float eps) {
  const int lane = threadIdx.x % WARP;
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / WARP;
  if (row >= rows) return;
  const int cpr = D / RowSlice<T>::VEC;
  RowSlice<T> xs;
  xs.load(x + static_cast<size_t>(row) * D, cpr, lane);
  const float2 st = row_stats(xs, cpr, D, lane, eps);
  float sc[LN_VALS], bi[LN_VALS];
  load_params<T>(sc, scale, cpr, lane);
  load_params<T>(bi, bias, cpr, lane);
#pragma unroll
  for (int i = 0; i < LN_VALS; ++i) {
    const float yh = (xs.v[i] - st.x) * st.y;
    xs.v[i] = yh * sc[i] + bi[i];
  }
  xs.store(y + static_cast<size_t>(row) * D, cpr, lane);
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

template <typename T>
cudaError_t launch_fwd(const void* x, const float* scale, const float* bias,
                       void* y, int rows, int D, float eps,
                       cudaStream_t stream) {
  const int blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  ln_fwd_kernel<T><<<blocks, LN_WARPS * WARP, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, D,
      eps);
  return cudaGetLastError();
}

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
// fp32. Contiguous, 16-byte aligned, on the current device. Returns the
// cudaError_t of the launch (0 = queued).
extern "C" int nezha_layer_norm_fwd(const void* x, const void* scale,
                                    const void* bias, void* y, int rows,
                                    int D, float eps, int x_dtype,
                                    void* stream) {
  if (nezha::bad_shape(rows, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (x_dtype == nezha::BF16)
    return nezha::launch_fwd<__nv_bfloat16>(x, s, b, y, rows, D, eps, st);
  if (x_dtype == nezha::F32)
    return nezha::launch_fwd<float>(x, s, b, y, rows, D, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
