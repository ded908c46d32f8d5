// What the attention kernels share of the TPU kernels' online softmax
// (nezha_tpu/ops/pallas/common.py: scratch_init, softmax_block_update,
// softmax_finalize, block_step): the dtype codes and conversions, the
// warp reductions and the finite constants.
//   - masked scores are NEG_BIG = -1e30, never -inf, so a fully masked
//     row stays NaN-free;
//   - the statistics and the accumulator are fp32; p is rounded to the
//     value dtype before P.V (common.py:67): round_to<T>;
//   - the output divides by max(l, 1e-30), so a row that folded no key
//     writes exact zeros (common.py:79): finalize_denom.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nezha {

constexpr float NEG_BIG = -1e30f;
constexpr int WARP = 32;
constexpr int MAX_D = 128;   // the widest head a kernel takes

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

// The guarded denominator of softmax_finalize.
__device__ __forceinline__ float finalize_denom(float l) {
  return fmaxf(l, 1e-30f);
}

// The per-row logsumexp the training forward emits beside its output
// (common.py:81-83): m + log(max(l, 1e-30)). The backward recomputes
// p = exp(s - lse) from it.
__device__ __forceinline__ float finalize_lse(float m, float l) {
  return m + logf(finalize_denom(l));
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
