// Paged flash-decode for Hopper (sm_90a).
//
// Replaces: nezha_tpu/ops/pallas/decode_attention.py:_paged_decode_kernel
// (float pools), reached from models/gpt2.py Attention._apply_paged on the
// serve engine's decode step.
//
// Computes, per (row b, head h): one query q[b, h] attends the row's cache
// prefix [0, lengths[b]) gathered through block_tables[b] from the block
// pools k/v [N, H, bs, D]. lengths are clamped to [0, M*bs]; a row with
// length 0 reads no table entry and no block and writes exact zeros.
//
// What bounds it: bytes. Each call must read the K and V positions below
// every row's length once: sum_b lengths[b] * H * D * 2 * sizeof(pool).
// At GPT-2 124M (H=12, D=64, bf16) that is 3 KiB per cached position, and
// the two dots do 4 flops per byte read, far below the ~295 flop/byte
// where the tensor cores would be the limit. The design therefore spends
// nothing on tensor cores and tries only to read each needed byte once and
// nothing more:
//   - work follows the data: a block walks only the table entries below
//     its row's length (the Pallas per-row block skip), so inactive rows
//     cost one length read;
//   - one thread block per (head, row), eight warps splitting the row's
//     positions into interleaved 32-key tiles (split-K inside the block),
//     each warp folding its tiles with the shared online softmax and the
//     partial states merged once at the end (decode_fold.cuh, the body
//     this kernel shares with the dense flash_decode.cu);
//   - tile loads are 16-byte vector loads on neighbouring addresses, all of
//     a lane's loads for a tile in flight together (stage_tile).
// Not done yet (later work): cp.async/TMA double-buffering, and a split-K
// across thread blocks for long rows at small batch, where B*H blocks
// leave SMs idle. Shared memory is 4 * (521 D + 272) bytes per block (the
// fp32 K and V tiles of eight warps): 134 KB at D=64 leaves room for one
// block per SM, and D above 104 exceeds the 227 KB a block may hold (the
// wrapper refuses it). Staging the tiles in the pool dtype would halve
// that for bf16 pools.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_fold.cuh"

namespace nezha {
namespace {

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(DEC_WARPS * WARP)
    paged_decode_kernel(const TQ* __restrict__ q,
                        const TKV* __restrict__ k_pool,
                        const TKV* __restrict__ v_pool,
                        const int* __restrict__ lengths,
                        const int* __restrict__ tables,
                        TQ* __restrict__ out, int H, int D, int bs, int M,
                        float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > M * bs ? M * bs : len);
  const int* tab = tables + static_cast<size_t>(b) * M;
  decode_row<TQ>(
      smem, q, out, (static_cast<size_t>(b) * H + h) * D, len, D, scale,
      cache_tiles(k_pool, v_pool, [&](int p) {
        return ((static_cast<size_t>(tab[p / bs]) * H + h) * bs + p % bs) * D;
      }));
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, const int* tables, void* out, int B,
                   int H, int D, int bs, int M, float scale,
                   cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(D);
  auto kernel = paged_decode_kernel<TQ, TKV>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), DEC_WARPS * WARP, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), lengths, tables, static_cast<TQ*>(out), H,
      D, bs, M, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nezha

// q [B, H, 1, D]; k_pool/v_pool [N, H, bs, D]; lengths [B] int32;
// tables [B, M] int32; out [B, H, 1, D] of q's dtype. All contiguous, on
// the current device. Returns the cudaError_t of the launch (0 = queued).
extern "C" int nezha_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* lengths,
                                  const void* tables, void* out, int B,
                                  int H, int D, int bs, int M, float scale,
                                  int q_dtype, int kv_dtype, void* stream) {
  using nezha::BF16;
  using nezha::F32;
  if (B <= 0 || H <= 0 || D <= 0 || D > nezha::MAX_D || D % 8 || bs <= 0 ||
      M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (q_dtype == BF16 && kv_dtype == BF16)
    return nezha::launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, len, tab, out, B, H, D, bs, M, scale, s);
  if (q_dtype == F32 && kv_dtype == BF16)
    return nezha::launch<float, __nv_bfloat16>(q, k_pool, v_pool, len, tab,
                                               out, B, H, D, bs, M, scale, s);
  if (q_dtype == BF16 && kv_dtype == F32)
    return nezha::launch<__nv_bfloat16, float>(q, k_pool, v_pool, len, tab,
                                               out, B, H, D, bs, M, scale, s);
  if (q_dtype == F32 && kv_dtype == F32)
    return nezha::launch<float, float>(q, k_pool, v_pool, len, tab, out, B, H,
                                       D, bs, M, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
