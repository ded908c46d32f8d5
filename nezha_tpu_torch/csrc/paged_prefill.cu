// Paged flash-prefill for Hopper (sm_90a), float pools.
//
// Replaces: nezha_tpu/ops/pallas/prefill_attention.py:_prefill_kernel,
// reached from models/gpt2.py Attention._apply_paged on each prefill chunk
// the serve engine dispatches; and, launched with q_offsets, the same
// kernel replaces _prefill_qoff_kernel, reached from the ring variant of
// sequence-sharded prefill (serve/sharded/seq_prefill.py) once per hop and
// shard.
//
// Computes, per (row b, head h, query i of the chunk): query i sits at
// absolute position starts[b] + i and attends the row's cached prefix
// [0, starts[b]) through block_tables[b] into the pools k/v [N, H, bs, D],
// then the chunk's own fresh k_chunk/v_chunk causally (keys j <= i). The
// kernel never reads the pool at chunk positions, so the caller's one
// scatter of the chunk into the pool and this kernel commute.
//
// Dtypes of the dots follow the TPU kernel: the prefix fold casts q to the
// pool dtype and p to the pool dtype (block_step); the chunk's fresh K/V
// are routed through the pool dtype and then to q's dtype, and p is cast
// to q's dtype (prefill_attention.py:120-124) — so a bf16 pool attends the
// same values the composed gather-after-write path reads back.
//
// What bounds it: at the engine's shapes (one row per call, S up to 256
// queries, prefixes up to ~1k positions, D=64) the work is
// 4 * S * (start + S/2) * D flops per head against
// (start + S) * D * 2 * sizeof(pool) bytes of K/V read at least once —
// for S=256 that is ~128 flop/byte, below the H100's ~295 flop/byte bf16
// ridge, so the least time is set by bytes (~1 us at S=256, start=768).
// What bounds this kernel is latency: a warp folds a 64-key tile (Q.K^T
// and P.V on the tensor cores, mma.sync, the softmax between) in a few
// microseconds of dependent instructions, and a row has ~16 tiles. The
// fold (prefill_fold.cuh) therefore splits the tiles over the warps of a
// block: 8 warps, 4 key splits, so a block owns 32 query rows and each
// warp folds every 4th tile of its 16 rows, the tiles gathered through
// the block table in 16-byte loads, 4 tiles at once.
// The shape was chosen on the card with tools/tune_prefill_rows.py (NVIDIA
// H100 80GB HBM3, 700.00 W; B9 at S=256, start 768, H=12; B11 the ring
// hop, H=3, 64 queries): 8 warps x 4 splits 0.0394 ms (B11 0.0343-0.0355),
// 8 x 2 0.0565 (0.0505-0.0564), 16 x 4 0.0429 (0.0401-0.0426).
//
// The q-offset form (entry nezha_paged_prefill_qoff, q_offsets given):
// the S_q queries of row b sit at absolute positions q_offsets[b] + i
// while the chunk's S_kc fresh K/V rows still occupy [starts[b],
// starts[b] + S_kc), so query i's causal diagonal in the chunk moves to
// qoff + i with qoff = q_offsets[b] - starts[b] >= 0. A mesh shard hands
// its slice of a chunk's queries to this form against the full chunk.
// Both entries launch the same kernel: without q_offsets qoff is 0 and
// the chunk is the query rows themselves. A row folds exactly the tiles
// it folds as a query of the full chunk (the same prefix tiles, the same
// 64-key chunk tiles from c0 = 0), and a trailing tile wholly past its
// diagonal leaves its state bitwise as it was (prefill_fold.cuh), so the
// two forms give the same bits for that query.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "prefill_fold.cuh"

namespace nezha {
namespace {

using prefill::Copy;
using prefill::Rounded;

template <typename TQ, typename TKV, int ND>
__global__ void __launch_bounds__(prefill::THREADS)
    paged_prefill_kernel(const TQ* __restrict__ q,
                         const TQ* __restrict__ k_chunk,
                         const TQ* __restrict__ v_chunk,
                         const TKV* __restrict__ k_pool,
                         const TKV* __restrict__ v_pool,
                         const int* __restrict__ tables,
                         const int* __restrict__ starts,
                         TQ* __restrict__ out, int H, int S, int D, int bs,
                         int M, float scale,
                         // The q-offset form's own; without it null, and
                         // the chunk is the S query rows.
                         const int* __restrict__ q_offsets, int S_kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  int start = starts[b];
  // Chunk-local position of query 0 (0 without q_offsets).
  const int qoff = q_offsets != nullptr ? q_offsets[b] - start : 0;
  start = start < 0 ? 0 : (start > M * bs ? M * bs : start);
  const int* tab = tables + static_cast<size_t>(b) * M;

  // The cached prefix, read through the block table as stored: the prefix
  // dots run in the pool dtype.
  auto prefix = prefill::tiles<TKV, ND, Copy>(k_pool, v_pool, [=](int p) {
    return ((static_cast<size_t>(tab[p / bs]) * H + h) * bs + p % bs) * D;
  });
  // The chunk's fresh K/V, routed through the pool dtype, then to q's.
  using ChunkCvt = typename std::conditional<std::is_same<TQ, TKV>::value,
                                             Copy, Rounded<TKV, TQ>>::type;
  auto chunk = prefill::tiles<TQ, ND, ChunkCvt>(
      k_chunk + bh * S_kc * D, v_chunk + bh * S_kc * D,
      [=](int c) { return static_cast<size_t>(c) * D; });
  prefill::prefill_rows<TQ, TKV, ND>(smem, q + bh * S * D, out + bh * S * D,
                                     S, S_kc, qoff, start, D, scale, prefix,
                                     chunk);
}

template <typename TQ, typename TKV, int ND>
cudaError_t launch_nd(const void* q, const void* kc, const void* vc,
                      const void* kp, const void* vp, const int* tables,
                      const int* starts, const int* q_offsets, void* out,
                      int B, int H, int S, int S_kc, int D, int bs, int M,
                      float scale, cudaStream_t stream) {
  using Plan = prefill::Plan<TQ, TKV, TKV, ND>;
  const size_t smem = Plan::smem_bytes(D);
  auto kernel = paged_prefill_kernel<TQ, TKV, ND>;
  cudaError_t err = flash::prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + Plan::QT - 1) / Plan::QT, H, B);
  kernel<<<grid, prefill::THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(kc),
      static_cast<const TQ*>(vc), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), tables, starts, static_cast<TQ*>(out), H,
      S, D, bs, M, scale, q_offsets, S_kc);
  return cudaGetLastError();
}

// The accumulator holds D / 8 column groups: 8 up to D = 64, else 16.
template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* kp, const void* vp, const int* tables,
                   const int* starts, const int* q_offsets, void* out, int B,
                   int H, int S, int S_kc, int D, int bs, int M, float scale,
                   cudaStream_t stream) {
  if (D <= 64)
    return launch_nd<TQ, TKV, 8>(q, kc, vc, kp, vp, tables, starts,
                                 q_offsets, out, B, H, S, S_kc, D, bs, M,
                                 scale, stream);
  return launch_nd<TQ, TKV, 16>(q, kc, vc, kp, vp, tables, starts, q_offsets,
                                out, B, H, S, S_kc, D, bs, M, scale, stream);
}

// The dtype dispatch both entry points share.
int dispatch(const void* q, const void* k_chunk, const void* v_chunk,
             const void* k_pool, const void* v_pool, const void* tables,
             const void* starts, const void* q_offsets, void* out, int B,
             int H, int S, int S_kc, int D, int bs, int M, float scale,
             int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S_kc <= 0 || D <= 0 || D > MAX_D ||
      D % 8 || bs <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tab = static_cast<const int*>(tables);
  const int* st = static_cast<const int*>(starts);
  const int* qo = static_cast<const int*>(q_offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (q_dtype == BF16 && kv_dtype == BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_chunk, v_chunk, k_pool, v_pool, tab, st, qo, out, B, H, S, S_kc,
        D, bs, M, scale, s);
  if (q_dtype == F32 && kv_dtype == BF16)
    return launch<float, __nv_bfloat16>(
        q, k_chunk, v_chunk, k_pool, v_pool, tab, st, qo, out, B, H, S, S_kc,
        D, bs, M, scale, s);
  if (q_dtype == BF16 && kv_dtype == F32)
    return launch<__nv_bfloat16, float>(
        q, k_chunk, v_chunk, k_pool, v_pool, tab, st, qo, out, B, H, S, S_kc,
        D, bs, M, scale, s);
  if (q_dtype == F32 && kv_dtype == F32)
    return launch<float, float>(q, k_chunk, v_chunk, k_pool, v_pool, tab,
                                st, qo, out, B, H, S, S_kc, D, bs, M, scale,
                                s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace nezha

// q/k_chunk/v_chunk [B, H, S, D] of one dtype; k_pool/v_pool [N, H, bs, D];
// tables [B, M] int32; starts [B] int32; out [B, H, S, D] of q's dtype.
// All contiguous, on the current device. Returns the launch's cudaError_t.
extern "C" int nezha_paged_prefill(const void* q, const void* k_chunk,
                                   const void* v_chunk, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* starts, void* out, int B,
                                   int H, int S, int D, int bs, int M,
                                   float scale, int q_dtype, int kv_dtype,
                                   void* stream) {
  return nezha::dispatch(q, k_chunk, v_chunk, k_pool, v_pool, tables, starts,
                         nullptr, out, B, H, S, S, D, bs, M, scale, q_dtype,
                         kv_dtype, stream);
}

// The q-offset form: q and out [B, H, S_q, D]; k_chunk/v_chunk
// [B, H, S_kc, D] of q's dtype; q_offsets [B] int32 with
// starts[b] <= q_offsets[b]; the rest as above.
extern "C" int nezha_paged_prefill_qoff(
    const void* q, const void* k_chunk, const void* v_chunk,
    const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, const void* q_offsets, void* out, int B, int H,
    int S_q, int S_kc, int D, int bs, int M, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  return nezha::dispatch(q, k_chunk, v_chunk, k_pool, v_pool, tables, starts,
                         q_offsets, out, B, H, S_q, S_kc, D, bs, M, scale,
                         q_dtype, kv_dtype, stream);
}
