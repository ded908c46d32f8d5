// The single-query decode fold both decode kernels share: the body of the
// paged kernel (paged_decode.cu) and of the dense one (flash_decode.cu),
// which differ only in where position p of a row's cache lives.
//
// One thread block owns one (row, head) query. Its eight warps split the
// row's positions [0, len) into interleaved 32-key tiles (warp w takes
// tiles w, w + 8, ...: split-K inside the block); each warp stages a tile
// of K and V into shared memory as fp32 (stage_tile), scores it one key per
// lane and folds it with the shared online softmax (fold_tile). The warps'
// partial states are merged once at the end, in warp order, and the block
// writes acc / max(l, 1e-30) in q's dtype. A row with len == 0 folds no
// tile and writes exact zeros.
//
// Semantics kept from the Pallas block_step (ops/pallas/common.py:86-98):
// q is rounded to the cache dtype before Q.K, p to v's dtype before P.V,
// statistics and the accumulator are fp32, masked lanes score NEG_BIG.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "online_softmax.cuh"

namespace nezha {

constexpr int DEC_WARPS = 8;

// Dynamic shared memory of one decode block: q, each warp's fp32 K tile
// [32][D+1] and V tile [32][D], and the warps' merge rows [warps][D+2].
inline size_t decode_smem_bytes(int D) {
  return sizeof(float) * (D + DEC_WARPS * (WARP * (D + 1) + WARP * D) +
                          DEC_WARPS * (D + 2));
}

// Attend q[qrow .. qrow + D) over the first `len` positions of one row of
// the cache; `addr(p)` is the element offset in k and v of position p's
// D-vector. Called by every thread of a DEC_WARPS-warp block with `smem`
// holding decode_smem_bytes(D) bytes.
template <typename TQ, typename TKV, typename Addr>
__device__ __forceinline__ void decode_row(float* __restrict__ smem,
                                           const TQ* __restrict__ q,
                                           const TKV* __restrict__ k,
                                           const TKV* __restrict__ v,
                                           TQ* __restrict__ out, size_t qrow,
                                           int len, int D, float scale,
                                           Addr addr) {
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int ldk = D + 1;
  const int tile_floats = WARP * ldk + WARP * D;

  float* qs = smem;                                   // [D]
  float* kt = qs + D + warp * tile_floats;            // [32][D+1]
  float* vt = kt + WARP * ldk;                        // [32][D]
  float* mrg = qs + D + DEC_WARPS * tile_floats;      // [warps][D+2]

  // block_step casts q to the cache dtype before Q.K (common.py:93).
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    qs[d] = round_to<TKV>(to_float(q[qrow + d]));
  __syncthreads();

  RowState st;
  st.init();
  for (int t0 = warp * WARP; t0 < len; t0 += DEC_WARPS * WARP) {
    const int n = min(WARP, len - t0);
    stage_tile(
        kt, vt, ldk, k, v, [&](int j) { return addr(t0 + j); }, n, D, lane,
        WARP, Identity());
    __syncwarp();
    const float s =
        lane < n ? tile_score(qs, kt, ldk, D, lane) * scale : NEG_BIG;
    fold_tile<TKV>(st, s, vt, n, D, lane);   // p cast to v's dtype
    __syncwarp();
  }

  // Merge the warps' partial states: the split-K combine.
  float* mine = mrg + warp * (D + 2);
  if (lane == 0) {
    mine[D] = st.m;
    mine[D + 1] = st.l;
  }
#pragma unroll
  for (int k = 0; k < DPL; ++k) {
    const int d = lane + k * WARP;
    if (d < D) mine[d] = st.acc[k];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float m = NEG_BIG;
    for (int w = 0; w < DEC_WARPS; ++w) m = fmaxf(m, mrg[w * (D + 2) + D]);
    float l = 0.f, acc = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float* part = mrg + w * (D + 2);
      const float c = expf(part[D] - m);
      l += part[D + 1] * c;
      acc += part[d] * c;
    }
    out[qrow + d] = from_float<TQ>(acc / finalize_denom(l));
  }
}

}  // namespace nezha
