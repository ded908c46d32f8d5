// Paged flash-prefill for Hopper (sm_90a), float pools.
//
// Replaces: nezha_tpu/ops/pallas/prefill_attention.py:_prefill_kernel,
// reached from models/gpt2.py Attention._apply_paged on each prefill chunk
// the serve engine dispatches; and, as the QOFF instantiation of the same
// body, _prefill_qoff_kernel, reached from the ring variant of
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
// ridge, so the minimum is set by bytes; a fp32-FMA kernel like this one
// is bound by its own arithmetic instead (67 TFLOP/s, not 989). This first
// version is simple and right:
//   - one thread block per (16-query tile, head, row); each of its 8 warps
//     owns 2 query rows and keeps their online-softmax state in registers;
//   - K/V stream through shared memory 32 keys at a time in 16-byte vector
//     loads, each tile loaded once per block and scored by every warp, the
//     prefix tile gathered row by row through the block table;
//   - prefix work stops at starts[b] and chunk tiles stop at the tile's
//     causal diagonal, so work tracks the row's real depth.
// Later work: wgmma on bf16 tiles with TMA-fed shared memory, which moves
// the bound from the FMA pipes to the memory system.
//
// The q-offset form (QOFF = true, entry nezha_paged_prefill_qoff): the
// S_q queries of row b sit at absolute positions q_offsets[b] + i while
// the chunk's S_kc fresh K/V rows still occupy [starts[b], starts[b] +
// S_kc), so query i's causal diagonal in the chunk moves to
// qoff + i with qoff = q_offsets[b] - starts[b] >= 0. A mesh shard hands
// its slice of a chunk's queries to this form against the full chunk. A
// row folds exactly the tiles the QOFF = false form folds for the same
// query of the full chunk (the same prefix tiles, the same 32-key chunk
// tiles from c0 = 0), and a trailing tile wholly past its diagonal leaves
// its state bitwise as it was (p = exp(NEG_BIG - m) = 0, corr = 1), so the
// two forms give the same bits for that query. With QOFF = false every
// q-offset term is the constant 0 and the chunk is the query rows
// themselves: that instantiation is the float prefill kernel unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "online_softmax.cuh"

namespace nezha {
namespace {

constexpr int PF_WARPS = 8;
constexpr int ROWS_PER_WARP = 2;
constexpr int Q_TILE = PF_WARPS * ROWS_PER_WARP;

template <typename TQ, typename TKV, bool QOFF>
__global__ void __launch_bounds__(PF_WARPS * WARP)
    paged_prefill_kernel(const TQ* __restrict__ q,
                         const TQ* __restrict__ k_chunk,
                         const TQ* __restrict__ v_chunk,
                         const TKV* __restrict__ k_pool,
                         const TKV* __restrict__ v_pool,
                         const int* __restrict__ tables,
                         const int* __restrict__ starts,
                         TQ* __restrict__ out, int H, int S, int D, int bs,
                         int M, float scale,
                         // The q-offset form's own (last, so that the
                         // float form's parameters keep their offsets).
                         const int* __restrict__ q_offsets, int S_kc) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * Q_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int ldk = D + 1;

  float* q_kv = smem;                  // [Q_TILE][D] q cast to pool dtype
  float* q_raw = q_kv + Q_TILE * D;    // [Q_TILE][D] q as given
  float* kt = q_raw + Q_TILE * D;      // [32][D+1]
  float* vt = kt + WARP * ldk;         // [32][D]

  const size_t head = (static_cast<size_t>(b) * H + h) * S;   // row offset
  // The chunk's rows: the queries themselves unless QOFF.
  const int skc = QOFF ? S_kc : S;
  const size_t chunk_head = (static_cast<size_t>(b) * H + h) * skc;
  for (int e = threadIdx.x; e < Q_TILE * D; e += blockDim.x) {
    const int r = e / D;
    const int d = e - r * D;
    const float x =
        q0 + r < S ? to_float(q[(head + q0 + r) * D + d]) : 0.f;
    q_raw[e] = x;
    q_kv[e] = round_to<TKV>(x);
  }

  RowState st[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) st[i].init();

  int start = starts[b];
  // Chunk-local position of query 0 (0 unless QOFF).
  const int qoff = QOFF ? q_offsets[b] - start : 0;
  start = start < 0 ? 0 : (start > M * bs ? M * bs : start);
  const int* tab = tables + static_cast<size_t>(b) * M;

  // The cached prefix [0, start), read through the block table.
  for (int t0 = 0; t0 < start; t0 += WARP) {
    const int n = min(WARP, start - t0);
    __syncthreads();
    stage_tile(
        kt, vt, ldk, k_pool, v_pool,
        [&](int j) {
          const int p = t0 + j;
          return ((static_cast<size_t>(tab[p / bs]) * H + h) * bs + p % bs) *
                 D;
        },
        n, D, threadIdx.x, blockDim.x, Identity());
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      const float s =
          lane < n ? tile_score(q_kv + r * D, kt, ldk, D, lane) * scale
                   : NEG_BIG;
      fold_tile<TKV>(st[i], s, vt, n, D, lane);
    }
  }

  // The chunk itself, causally, up to this tile's last query.
  const int last = min(skc, qoff + q0 + Q_TILE) - 1;
  for (int c0 = 0; c0 <= last; c0 += WARP) {
    const int n = min(WARP, skc - c0);
    __syncthreads();
    // The chunk's fresh K/V, routed through the pool dtype, then to q's.
    stage_tile(
        kt, vt, ldk, k_chunk, v_chunk,
        [&](int j) { return (chunk_head + c0 + j) * D; }, n, D, threadIdx.x,
        blockDim.x, [](float x) { return round_to<TQ>(round_to<TKV>(x)); });
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      const bool attend = lane < n && c0 + lane <= qoff + q0 + r;
      const float s =
          attend ? tile_score(q_raw + r * D, kt, ldk, D, lane) * scale
                 : NEG_BIG;
      fold_tile<TQ>(st[i], s, vt, n, D, lane);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int qi = q0 + warp * ROWS_PER_WARP + i;
    if (qi >= S) continue;
    const float inv = 1.f / finalize_denom(st[i].l);
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int d = lane + k * WARP;
      if (d < D)
        out[(head + qi) * D + d] = from_float<TQ>(st[i].acc[k] * inv);
    }
  }
}

template <typename TQ, typename TKV, bool QOFF>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* kp, const void* vp, const int* tables,
                   const int* starts, const int* q_offsets, void* out, int B,
                   int H, int S, int S_kc, int D, int bs, int M, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * Q_TILE * D + WARP * (D + 1) + WARP * D);
  auto kernel = paged_prefill_kernel<TQ, TKV, QOFF>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + Q_TILE - 1) / Q_TILE, H, B);
  kernel<<<grid, PF_WARPS * WARP, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(kc),
      static_cast<const TQ*>(vc), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), tables, starts, static_cast<TQ*>(out), H,
      S, D, bs, M, scale, q_offsets, S_kc);
  return cudaGetLastError();
}

// The dtype dispatch both entry points share.
template <bool QOFF>
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
    return launch<__nv_bfloat16, __nv_bfloat16, QOFF>(
        q, k_chunk, v_chunk, k_pool, v_pool, tab, st, qo, out, B, H, S, S_kc,
        D, bs, M, scale, s);
  if (q_dtype == F32 && kv_dtype == BF16)
    return launch<float, __nv_bfloat16, QOFF>(
        q, k_chunk, v_chunk, k_pool, v_pool, tab, st, qo, out, B, H, S, S_kc,
        D, bs, M, scale, s);
  if (q_dtype == BF16 && kv_dtype == F32)
    return launch<__nv_bfloat16, float, QOFF>(
        q, k_chunk, v_chunk, k_pool, v_pool, tab, st, qo, out, B, H, S, S_kc,
        D, bs, M, scale, s);
  if (q_dtype == F32 && kv_dtype == F32)
    return launch<float, float, QOFF>(q, k_chunk, v_chunk, k_pool, v_pool,
                                      tab, st, qo, out, B, H, S, S_kc, D, bs,
                                      M, scale, s);
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
  return nezha::dispatch<false>(q, k_chunk, v_chunk, k_pool, v_pool, tables,
                                starts, nullptr, out, B, H, S, S, D, bs, M,
                                scale, q_dtype, kv_dtype, stream);
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
  return nezha::dispatch<true>(q, k_chunk, v_chunk, k_pool, v_pool, tables,
                               starts, q_offsets, out, B, H, S_q, S_kc, D,
                               bs, M, scale, q_dtype, kv_dtype, stream);
}
