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

// Stage one tile of up to 32 dequantized K and V rows into shared memory
// as fp32, in the layout of stage_tile (online_softmax.cuh): K with row
// stride ldk, V with row stride D, rows n..31 zero. Row j's int8 data
// starts at element row_off(j) of k and v, its scales at index
// row_scale(j) of ks and vs: a tile may span several pool blocks, so the
// scale is looked up per row. Rows at or past n load neither data nor
// scale. Each thread moves whole 16-byte chunks (16 int8 values): D must
// be a multiple of 16 and the pools 16-byte aligned.
template <typename T, typename RowOff, typename RowScale>
__device__ __forceinline__ void stage_tile_q8(
    float* __restrict__ kd, float* __restrict__ vd, int ldk,
    const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    RowOff row_off, RowScale row_scale, int n, int D, int tid, int nthr) {
  constexpr int VEC = 16;
  const int cpr = D / VEC;
  const int total = WARP * cpr;
#pragma unroll 4
  for (int c = tid; c < total; c += nthr) {
    const int j = c / cpr;
    const int col = (c - j * cpr) * VEC;
    uint4 kraw = make_uint4(0u, 0u, 0u, 0u);
    uint4 vraw = kraw;
    float ksc = 0.f, vsc = 0.f;
    if (j < n) {
      const size_t off = row_off(j) + col;
      kraw = *reinterpret_cast<const uint4*>(k + off);
      vraw = *reinterpret_cast<const uint4*>(v + off);
      const size_t si = row_scale(j);
      ksc = ks[si];
      vsc = vs[si];
    }
    const int8_t* kq = reinterpret_cast<const int8_t*>(&kraw);
    const int8_t* vq = reinterpret_cast<const int8_t*>(&vraw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      kd[j * ldk + col + e] = dequant<T>(kq[e], ksc);
      vd[j * D + col + e] = dequant<T>(vq[e], vsc);
    }
  }
}

// Tiles of an int8 pool for decode_row (decode_fold.cuh): dequantized and
// rounded to the query's dtype, which is also the dtype q and p take
// before the dots (the int8 kernel dots in the query's dtype).
template <typename TQ, typename Addr, typename ScaleAt>
struct QuantTiles {
  using Dot = TQ;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  Addr addr;          // position -> element offset of its D-vector
  ScaleAt scale_at;   // position -> index of its (block, head) scale

  __device__ __forceinline__ void stage(float* kt, float* vt, int ldk,
                                        int t0, int n, int D, int tid,
                                        int nthr) const {
    stage_tile_q8<TQ>(
        kt, vt, ldk, k, v, ks, vs, [&](int j) { return addr(t0 + j); },
        [&](int j) { return scale_at(t0 + j); }, n, D, tid, nthr);
  }
};

template <typename TQ, typename Addr, typename ScaleAt>
__device__ __forceinline__ QuantTiles<TQ, Addr, ScaleAt> quant_tiles(
    const int8_t* k, const int8_t* v, const float* ks, const float* vs,
    Addr addr, ScaleAt scale_at) {
  return {k, v, ks, vs, addr, scale_at};
}

}  // namespace nezha
