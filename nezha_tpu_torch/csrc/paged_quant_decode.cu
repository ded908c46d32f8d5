// Paged flash-decode over an int8 KV pool, for Hopper (sm_90a).
//
// Replaces: nezha_tpu/ops/pallas/decode_attention.py:
// _paged_quant_decode_kernel, reached from models/gpt2.py
// Attention._apply_paged on every decode step of an int8 engine
// (ServeConfig.kv_dtype="int8").
//
// Computes, per (row b, head h): one query q[b, h] attends the row's cache
// prefix [0, lengths[b]) gathered through block_tables[b] from the int8
// pools k/v [N, H, bs, D], each position dequantized with its (block,
// head) scale from k_scale/v_scale [N, H]: (int8 * scale) rounded to q's
// dtype, the expression of ops/quant.dequantize_kv_block. The dots run in
// q's dtype over those tiles (q is not rounded to the pool dtype as in the
// float kernel), p is rounded to q's dtype before P.V, the statistics and
// the accumulator are fp32. lengths are clamped to [0, M*bs]; a row with
// length 0 reads no table entry, no block and no scale, and writes exact
// zeros.
//
// What bounds it: bytes. A call must read the int8 K and V positions below
// every row's length once (sum_b lengths[b] * H * D * 2 bytes, half of the
// bf16 kernel's), plus one scale per touched (block, head); the dots do 8
// flops per byte read, far below the tensor cores' ridge. The design is
// the float paged kernel's (decode_fold.cuh: one block per (head, row),
// eight warps splitting the row's positions into interleaved 32-key tiles,
// merged once at the end) with an int8 tile source (kv_quant.cuh
// QuantTiles): 16-byte loads of 16 int8 values, the dequant fused into the
// staging, and the scale looked up per position, since a 32-key tile spans
// two 16-position pool blocks. Not done yet (later work, as for the float
// kernel): staging the tiles narrower than fp32, cp.async/TMA overlap and
// a split-K across blocks for long rows at small batch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_fold.cuh"
#include "kv_quant.cuh"

namespace nezha {
namespace {

template <typename TQ>
__global__ void __launch_bounds__(DEC_WARPS * WARP)
    paged_quant_decode_kernel(const TQ* __restrict__ q,
                              const int8_t* __restrict__ k_pool,
                              const int8_t* __restrict__ v_pool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ lengths,
                              const int* __restrict__ tables,
                              TQ* __restrict__ out, int H, int D, int bs,
                              int M, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > M * bs ? M * bs : len);
  const int* tab = tables + static_cast<size_t>(b) * M;
  auto scale_at = [&](int p) {
    return static_cast<size_t>(tab[p / bs]) * H + h;
  };
  decode_row<TQ>(smem, q, out, (static_cast<size_t>(b) * H + h) * D, len, D,
                 scale,
                 quant_tiles<TQ>(
                     k_pool, v_pool, k_scale, v_scale,
                     [&](int p) { return (scale_at(p) * bs + p % bs) * D; },
                     scale_at));
}

template <typename TQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const int* lengths,
                   const int* tables, void* out, int B, int H, int D, int bs,
                   int M, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(D);
  auto kernel = paged_quant_decode_kernel<TQ>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), DEC_WARPS * WARP, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), lengths, tables, static_cast<TQ*>(out),
      H, D, bs, M, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nezha

// q [B, H, 1, D] f32 or bf16; k_pool/v_pool [N, H, bs, D] int8; k_scale/
// v_scale [N, H] f32; lengths [B] int32; tables [B, M] int32; out
// [B, H, 1, D] of q's dtype. All contiguous, on the current device, D a
// multiple of 16. Returns the cudaError_t of the launch (0 = queued).
extern "C" int nezha_paged_quant_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* lengths,
    const void* tables, void* out, int B, int H, int D, int bs, int M,
    float scale, int q_dtype, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > nezha::MAX_D || D % 16 || bs <= 0 ||
      M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (q_dtype == nezha::BF16)
    return nezha::launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                        len, tab, out, B, H, D, bs, M, scale,
                                        s);
  if (q_dtype == nezha::F32)
    return nezha::launch<float>(q, k_pool, v_pool, k_scale, v_scale, len,
                                tab, out, B, H, D, bs, M, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
