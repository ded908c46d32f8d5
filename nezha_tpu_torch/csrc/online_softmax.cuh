// The online-softmax fold both paged attention kernels share — the
// counterpart of nezha_tpu/ops/pallas/common.py (scratch_init,
// softmax_block_update, softmax_finalize, block_step).
//
// One warp owns one query row. A tile of up to 32 key positions is staged
// in shared memory as fp32; lane j scores key j, and the warp folds the
// tile into the row's running (max m, denominator l, fp32 accumulator acc)
// with the same arithmetic the Pallas kernels use:
//   - masked scores are NEG_BIG = -1e30, never -inf, so a fully masked
//     row stays NaN-free;
//   - m, l and acc are fp32; p is rounded to the value tile's dtype before
//     the P.V product (common.py:67), exactly as the TPU kernel feeds the
//     MXU;
//   - the output divides by max(l, 1e-30), so a row that folded no tile
//     writes exact zeros (common.py:79).
// Each lane holds the accumulator for head dims lane, lane + 32, ... (up to
// MAX_D), so the P.V loop reads the value tile conflict-free.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nezha {

constexpr float NEG_BIG = -1e30f;
constexpr int WARP = 32;
constexpr int MAX_D = 128;
constexpr int DPL = MAX_D / WARP;   // accumulator slots per lane

// dtype codes shared with the Python wrappers (ops/cuda/*.py)
enum DType : int { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

// x rounded through dtype T and back: the value a cast to T would hold.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = WARP / 2; o; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = WARP / 2; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct RowState {
  float m;
  float l;
  float acc[DPL];

  __device__ __forceinline__ void init() {
    m = NEG_BIG;
    l = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) acc[k] = 0.f;
  }
};

// Score of key `lane` against the query row: sum_d q[d] * k[lane][d].
// q is read as a broadcast, k with row stride ldk = D + 1 (conflict-free).
__device__ __forceinline__ float tile_score(const float* q, const float* k,
                                            int ldk, int D, int lane) {
  const float* krow = k + lane * ldk;
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(q[d], krow[d], s);
  return s;
}

// Fold one tile into the row. `s` is this lane's masked score (NEG_BIG for
// a masked key or a lane past n_keys); v holds n_keys value rows of D fp32
// with row stride D. PT is the dtype p is rounded to before P.V. The caller
// guarantees the tile has at least one unmasked key, or that the row
// already folded one — the same guarantee the Pallas kernels' block skip
// gives.
template <typename PT>
__device__ __forceinline__ void fold_tile(RowState& st, float s,
                                          const float* v, int n_keys, int D,
                                          int lane) {
  const float m_new = fmaxf(st.m, warp_max(s));
  const float p = expf(s - m_new);
  const float corr = expf(st.m - m_new);
  st.l = corr * st.l + warp_sum(p);
  const float pr = round_to<PT>(p);
#pragma unroll
  for (int k = 0; k < DPL; ++k) st.acc[k] *= corr;
  for (int j = 0; j < n_keys; ++j) {
    const float pj = __shfl_sync(0xffffffffu, pr, j);
    const float* vrow = v + j * D;
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int d = lane + k * WARP;
      if (d < D) st.acc[k] = fmaf(pj, vrow[d], st.acc[k]);
    }
  }
  st.m = m_new;
}

// Stage one tile of up to 32 K and V rows into shared memory as fp32: K
// with row stride ldk (= D + 1, for conflict-free lane-per-key scoring), V
// with row stride D. Row j (< n) starts at element row_off(j) of k and v;
// rows n..31 are zero-filled. Threads tid, tid + nthr, ... each move whole
// 16-byte chunks; a thread's chunks are independent and the loop unrolled,
// so several loads are in flight at once instead of one latency per
// element. `cvt`
// maps each loaded value to the value the dot must see (a rounding through
// another dtype, or the identity).
template <typename T, typename RowOff, typename Cvt>
__device__ __forceinline__ void stage_tile(float* __restrict__ kd,
                                           float* __restrict__ vd, int ldk,
                                           const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           RowOff row_off, int n, int D,
                                           int tid, int nthr, Cvt cvt) {
  // Elements of T in one 16-byte load: D must be a multiple of it (the
  // wrappers require D % 8 == 0 and 16-byte aligned tensors).
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int cpr = D / VEC;                 // chunks per row
  const int total = WARP * cpr;
#pragma unroll 4
  for (int c = tid; c < total; c += nthr) {
    const int j = c / cpr;
    const int col = (c - j * cpr) * VEC;
    uint4 kraw = make_uint4(0u, 0u, 0u, 0u);
    uint4 vraw = kraw;
    if (j < n) {
      const size_t off = row_off(j) + col;
      kraw = *reinterpret_cast<const uint4*>(k + off);
      vraw = *reinterpret_cast<const uint4*>(v + off);
    }
    const T* kt = reinterpret_cast<const T*>(&kraw);
    const T* vt = reinterpret_cast<const T*>(&vraw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      kd[j * ldk + col + e] = cvt(to_float(kt[e]));
      vd[j * D + col + e] = cvt(to_float(vt[e]));
    }
  }
}

struct Identity {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};

// The guarded denominator of softmax_finalize.
__device__ __forceinline__ float finalize_denom(float l) {
  return fmaxf(l, 1e-30f);
}

// Dynamic shared memory above the 48 KB default needs an opt-in per
// kernel; below it the call is skipped.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace nezha
