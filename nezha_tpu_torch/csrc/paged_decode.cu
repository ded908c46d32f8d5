// Paged flash-decode over a float KV pool for Hopper (sm_90a), split over
// the KV length.
//
// Replaces: nezha_tpu/ops/pallas/decode_attention.py:_paged_decode_kernel
// (float pools), reached from models/gpt2.py Attention._apply_paged on the
// serve engine's decode step, and per shard from serve/sharded/model.py on
// the sharded engine.
//
// Computes, per (row b, head h): one query q[b, h] attends the row's cache
// prefix [0, lengths[b]) gathered through block_tables[b] from the block
// pools k/v [N, H, bs, D]. lengths are clamped to [0, M*bs]; a row with
// length 0 reads no table entry and no block and writes exact zeros.
// Semantics of the TPU's block step (ops/pallas/common.py:86-98), a split
// being one block: q is rounded to the pool dtype before Q.K, p to the
// pool dtype before P.V, the statistics and the accumulator are fp32,
// masked keys score NEG_BIG.
//
// What bounds it: bytes. A call must read the K and V positions below
// every row's length once (sum_b lengths[b] * H * D * 2 * sizeof(pool)),
// and the dots do 4 flops per element read, far below the tensor cores'
// ridge. One block per (head, row), as this kernel ran until the split,
// gave 96 blocks for 132 SMs at the serving shape (B=8, H=12), 24 on a
// shard of a 4-way mesh, and one block walked the longest row alone, with
// fp32 tiles of 134 KB a block. It now runs the split walk it shares with
// the int8 paged decode (paged_split_decode.cuh), over a float pool:
//   - the split: the grid is (splits of M*bs, H, B), SPLIT keys a block, a
//     compile-time size (timed on the card with tools/tune_decode_split.py
//     --kernel paged). A block whose split starts at or past its row's
//     length loads nothing and leaves at once (split 0 of a length-0 row
//     stays to write its zeros). The split never depends on the lengths,
//     which live on the device, so the host never syncs;
//   - staging in the pool dtype: the split reads its pool blocks' table
//     entries once into shared memory, then copies its keys' K rows, then
//     their V rows, into shared memory with cp.async in two groups (V
//     still in flight while the scores and the softmax run). That is
//     2 * SPLIT * D * sizeof(pool) bytes (16 KB at D=64, bf16, 64 keys),
//     so several blocks fit on an SM. LPK lanes own a key, one 16-byte
//     chunk of its row each;
//   - the merge of the splits' fp32 partials in split order by the last
//     of the row's live splits to finish (split_decode.cuh): one launch a
//     call, bitwise repeatable.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_split_decode.cuh"

namespace nezha {
namespace {

constexpr int SPLIT = 64;               // keys a block folds
constexpr int PD_THREADS = 128;         // 4 warps

// A float pool for the split walk (paged_split_decode.cuh): values in the
// pool dtype, q and p rounded to it.
template <typename TQ, typename TKV>
struct FloatPool {
  using Elem = TKV;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(TKV));
  static constexpr bool SCALED = false;
  const TKV* k;
  const TKV* v;
  __device__ __forceinline__ float q_value(TQ x) const {
    return round_to<TKV>(to_float(x));
  }
  __device__ __forceinline__ float p_value(float p) const {
    return round_to<TKV>(p);
  }
  __device__ __forceinline__ float value(TKV e, float) const {
    return to_float(e);
  }
};

// One block: split blockIdx.x of (row b = blockIdx.z, head h =
// blockIdx.y); LPK lanes own a key (a power of two, at least D's 16-byte
// chunks).
template <typename TQ, typename TKV, int LPK>
__global__ void __launch_bounds__(PD_THREADS)
    paged_decode_split_kernel(
        const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
        const TKV* __restrict__ v_pool, const int* __restrict__ lengths,
        const int* __restrict__ tables, TQ* __restrict__ out,
        float* __restrict__ parts, int* __restrict__ counters, int H, int D,
        int bs, int M, float scale) {
  paged_split_decode<SPLIT, PD_THREADS, LPK>(
      FloatPool<TQ, TKV>{k_pool, v_pool}, q, lengths, tables, out, parts,
      counters, H, D, bs, M, scale);
}

template <typename TQ, typename TKV, int LPK>
cudaError_t launch_lpk(const void* q, const void* k, const void* v,
                       const int* lengths, const int* tables, void* out,
                       void* parts, void* counters, int B, int H, int D,
                       int bs, int M, float scale, cudaStream_t stream) {
  const size_t smem = paged_split_stage_bytes<SPLIT, FloatPool<TQ, TKV>>(D);
  auto kernel = paged_decode_split_kernel<TQ, TKV, LPK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M * bs + SPLIT - 1) / SPLIT, H, B);
  kernel<<<grid, PD_THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), lengths, tables, static_cast<TQ*>(out),
      static_cast<float*>(parts), static_cast<int*>(counters), H, D, bs, M,
      scale);
  record_grid(grid);
  return cudaGetLastError();
}

// The lanes a key takes: D's 16-byte chunks rounded up to 8, 16 or 32.
template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, const int* tables, void* out,
                   void* parts, void* counters, int B, int H, int D, int bs,
                   int M, float scale, cudaStream_t stream) {
  const int cpr = D * static_cast<int>(sizeof(TKV)) / 16;
  if (cpr <= 8)
    return launch_lpk<TQ, TKV, 8>(q, k, v, lengths, tables, out, parts,
                                  counters, B, H, D, bs, M, scale, stream);
  if (cpr <= 16)
    return launch_lpk<TQ, TKV, 16>(q, k, v, lengths, tables, out, parts,
                                   counters, B, H, D, bs, M, scale, stream);
  return launch_lpk<TQ, TKV, 32>(q, k, v, lengths, tables, out, parts,
                                 counters, B, H, D, bs, M, scale, stream);
}

}  // namespace
}  // namespace nezha

// The keys a block folds: the wrapper sizes the workspace from it.
extern "C" int nezha_paged_decode_split() { return nezha::SPLIT; }

// Writes the grid (x, y, z) of the last kernel nezha_paged_decode launched
// from this library into xyz[3]; zeros before the first. Returns 0.
extern "C" int nezha_paged_decode_last_grid(int* xyz) {
  for (int i = 0; i < 3; ++i) xyz[i] = nezha::last_grid[i];
  return 0;
}

// q [B, H, 1, D]; k_pool/v_pool [N, H, bs, D]; lengths [B] int32; tables
// [B, M] int32; out [B, H, 1, D] of q's dtype. All contiguous, on the
// current device, D a multiple of 8 up to 128, pools 16-byte aligned.
// parts: fp32 workspace of B * H * ceil(M * bs / split) * (D + 2) floats;
// counters: [B * H] int32, zero before the first call (each call leaves
// them zero). Calls that share counters must run in order (one stream).
// Returns the cudaError_t of the launch (0 = queued).
extern "C" int nezha_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* lengths,
                                  const void* tables, void* out, int B,
                                  int H, int D, int bs, int M, float scale,
                                  int q_dtype, int kv_dtype, void* stream,
                                  void* parts, void* counters) {
  using nezha::BF16;
  using nezha::F32;
  if (B <= 0 || H <= 0 || D <= 0 || D > nezha::MAX_D || D % 8 || bs <= 0 ||
      M <= 0 || parts == nullptr || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (q_dtype == BF16 && kv_dtype == BF16)
    return nezha::launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, len, tab, out, parts, counters, B, H, D, bs, M,
        scale, s);
  if (q_dtype == F32 && kv_dtype == BF16)
    return nezha::launch<float, __nv_bfloat16>(q, k_pool, v_pool, len, tab,
                                               out, parts, counters, B, H, D,
                                               bs, M, scale, s);
  if (q_dtype == BF16 && kv_dtype == F32)
    return nezha::launch<__nv_bfloat16, float>(q, k_pool, v_pool, len, tab,
                                               out, parts, counters, B, H, D,
                                               bs, M, scale, s);
  if (q_dtype == F32 && kv_dtype == F32)
    return nezha::launch<float, float>(q, k_pool, v_pool, len, tab, out,
                                       parts, counters, B, H, D, bs, M,
                                       scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
