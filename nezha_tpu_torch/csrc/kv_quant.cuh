// The int8 KV-cache policy on the card — the counterpart of
// nezha_tpu/ops/quant.py (quantize_kv_block, dequantize_kv_block) and of
// nezha_tpu_torch/ops/quant.py, shared by the int8 paged decode kernel
// (paged_quant_decode.cu) and the int8 prefill kernel (quant_prefill.cu).
//
// A pool holds int8 K/V [N, H, bs, D] and one fp32 scale per (block,
// head), [N, H]. Dequant is int8 -> fp32 times the scale, then rounded to
// the dtype the dots run in (the query's). Quantization of a block:
// sanitize (NaN -> 0, +-inf -> +-SATURATE_MAX), scale = amax / 127 (1 for
// an all-zero block), q = clamp(rint(x / scale), -127, 127). Every
// division is __fdiv_rn and every product __fmul_rn, so neither fast math
// nor FMA contraction can move a bit: the results are bitwise those of
// the PyTorch version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace nezha {

constexpr float QMAX = 127.f;
constexpr float SATURATE_MAX = 3.0e38f;

// int8 * scale in fp32, rounded to T: dequantize_kv_block(q, s, T).
template <typename T>
__device__ __forceinline__ float dequant(int8_t x, float scale) {
  return round_to<T>(__fmul_rn(static_cast<float>(x), scale));
}

__device__ __forceinline__ float sanitize(float x) {
  if (isnan(x)) return 0.f;
  if (isinf(x)) return x > 0.f ? SATURATE_MAX : -SATURATE_MAX;
  return x;
}

// absmax -> scale, with the zero guard.
__device__ __forceinline__ float quant_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, QMAX) : 1.f;
}

// x -> its int8 value (as a float), round half to even.
__device__ __forceinline__ float quantize(float x, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -QMAX), QMAX);
}

}  // namespace nezha
