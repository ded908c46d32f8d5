// Dense flash-decode for Hopper (sm_90a).
//
// Replaces: nezha_tpu/ops/pallas/decode_attention.py:_decode_kernel, reached
// from models/gpt2.py Attention.apply's dense-cache branch on every
// single-token step of models/generate.py (KV-cache generation).
//
// Computes, per (row b, head h): one query q[b, h] attends the row's cache
// prefix [0, lengths[b]) of the dense caches k/v [B, H, L, D]; position p
// of (b, h) is at element ((b*H + h)*L + p)*D. lengths are clamped to
// [0, L]; a row with length 0 reads nothing and writes exact zeros.
//
// What bounds it: bytes, as for the paged kernel. A call must read the K
// and V positions below every row's length once (sum_b lengths[b] * H * D
// * 2 * sizeof(cache)) and does 4 flops per element read, far below the
// ~295 flop/byte where the tensor cores would be the limit. The body is
// the paged kernel's (decode_fold.cuh) with a contiguous address map:
//   - no table read: a warp's 32-key tile is one contiguous 32*D run of K
//     and one of V, read in 16-byte loads on neighbouring addresses;
//   - the block size on this card: each of the 8 warps owns 32-key tiles,
//     so a block sweeps 256 keys per round with every lane's loads of a
//     tile in flight together. A tile never spans past the row's length
//     (the tail tile loads only its n valid keys and masks the rest), so
//     no length needs to be a multiple of anything. The TPU's 256-key
//     grid block (_pick_block(L, 256)) has no counterpart here: it sized
//     VMEM tiles, and nothing of it carries over to shared memory;
//   - one block per (head, row), merged in warp order: the output is the
//     same from run to run.
// Known limits (PERF.md): at B=8 and H=12 the grid is 96 blocks for 132
// SMs, and the fp32 tiles take 134 KB of shared memory at D=64, one block
// per SM; a split-K across blocks and tiles staged in the cache dtype are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_fold.cuh"

namespace nezha {
namespace {

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(DEC_WARPS * WARP)
    flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int* __restrict__ lengths,
                        TQ* __restrict__ out, int H, int L, int D,
                        float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > L ? L : len);
  const size_t row = static_cast<size_t>(b) * H + h;
  decode_row<TQ, TKV>(smem, q, k, v, out, row * D, len, D, scale,
                      [&](int p) { return (row * L + p) * D; });
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int H, int L, int D,
                   float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(D);
  auto kernel = flash_decode_kernel<TQ, TKV>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), DEC_WARPS * WARP, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), lengths, static_cast<TQ*>(out), H, L, D,
      scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nezha

// q [B, H, 1, D]; k/v [B, H, L, D]; lengths [B] int32; out [B, H, 1, D] of
// q's dtype. All contiguous, on the current device. Returns the cudaError_t
// of the launch (0 = queued).
extern "C" int nezha_flash_decode(const void* q, const void* k,
                                  const void* v, const void* lengths,
                                  void* out, int B, int H, int L, int D,
                                  float scale, int q_dtype, int kv_dtype,
                                  void* stream) {
  using nezha::BF16;
  using nezha::F32;
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0 || D > nezha::MAX_D || D % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (q_dtype == BF16 && kv_dtype == BF16)
    return nezha::launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, len, out, B,
                                                       H, L, D, scale, s);
  if (q_dtype == F32 && kv_dtype == BF16)
    return nezha::launch<float, __nv_bfloat16>(q, k, v, len, out, B, H, L, D,
                                               scale, s);
  if (q_dtype == BF16 && kv_dtype == F32)
    return nezha::launch<__nv_bfloat16, float>(q, k, v, len, out, B, H, L, D,
                                               scale, s);
  if (q_dtype == F32 && kv_dtype == F32)
    return nezha::launch<float, float>(q, k, v, len, out, B, H, L, D, scale,
                                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}
