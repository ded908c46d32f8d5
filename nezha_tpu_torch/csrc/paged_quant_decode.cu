// Paged flash-decode over an int8 KV pool for Hopper (sm_90a), split over
// the KV length.
//
// Replaces: nezha_tpu/ops/pallas/decode_attention.py:
// _paged_quant_decode_kernel, reached from models/gpt2.py
// Attention._apply_paged on every decode step of an int8 engine
// (ServeConfig.kv_dtype="int8"), and per shard from serve/sharded/model.py
// on the sharded int8 engine.
//
// Computes, per (row b, head h): one query q[b, h] attends the row's cache
// prefix [0, lengths[b]) gathered through block_tables[b] from the int8
// pools k/v [N, H, bs, D], each position dequantized with its (block,
// head) scale from k_scale/v_scale [N, H]: (int8 * scale) rounded to q's
// dtype, the expression of ops/quant.dequantize_kv_block. The dots run in
// q's dtype over those values (q is not rounded to the pool dtype as in
// the float kernel), p is rounded to q's dtype before P.V, the statistics
// and the accumulator are fp32, masked keys score NEG_BIG. lengths are
// clamped to [0, M*bs]; a row with length 0 reads no table entry, no block
// and no scale, and writes exact zeros.
//
// What bounds it: bytes. A call must read the int8 K and V positions below
// every row's length once (sum_b lengths[b] * H * D * 2 bytes), plus one
// scale per touched (block, head); the dots do 4 flops per byte read, far
// below the tensor cores' ridge. One block per (head, row), as this kernel
// ran before its split, gave 96 blocks for 132 SMs at the
// serving shape (B=8, H=12), 24 on a shard of a 4-way mesh, and one block
// walked the longest row alone. So it runs the split walk it shares with
// the float paged decode (paged_split_decode.cuh), over an int8 pool:
//   - the split: the grid is (splits of M*bs, H, B), SPLIT keys a block, a
//     compile-time size (64 timed faster than 128 and 256 on the H100, at
//     H=12 and H=3: tools/tune_decode_split.py --kernel quant). A block
//     whose split starts at or past its row's length loads nothing and
//     leaves at once (split 0 of a length-0 row stays to write its zeros).
//     The split never depends on the lengths, which live on the device, so
//     the host never syncs;
//   - staging as int8: the split reads its pool blocks' table entries once
//     into shared memory, then copies its keys' int8 K rows, then their V
//     rows, into shared memory with cp.async in two groups (V still in
//     flight while the scores and the softmax run), and one K and one V
//     scale per pool block. That is 2 * SPLIT * D bytes (8 KB at D=64 and
//     64 keys; the one-block kernel's fp32 tiles took 134 KB), so several
//     blocks fit on an SM;
//   - dequant in registers, exactly kv_quant.cuh's dequant<TQ>, so the
//     values entering the dots are bitwise the one-block kernel's: LPK
//     lanes own a key, one 16-byte chunk (16 int8 values) of its row each;
//   - the merge of the splits' fp32 partials in split order by the last
//     of the row's live splits to finish (split_decode.cuh): one launch a
//     call, bitwise repeatable.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_quant.cuh"
#include "paged_split_decode.cuh"

namespace nezha {
namespace {

constexpr int SPLIT = 64;               // keys a block folds
constexpr int QD_THREADS = 128;         // 4 warps

// An int8 pool for the split walk (paged_split_decode.cuh): one K and one
// V scale per (block, head), values dequantized to q's dtype, the dots in
// q's dtype, p rounded to it.
template <typename TQ>
struct Int8Pool {
  using Elem = int8_t;
  static constexpr int VEC = 16;
  static constexpr bool SCALED = true;
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  __device__ __forceinline__ float q_value(TQ x) const { return to_float(x); }
  __device__ __forceinline__ float p_value(float p) const {
    return round_to<TQ>(p);
  }
  __device__ __forceinline__ float value(int8_t e, float s) const {
    return dequant<TQ>(e, s);
  }
};

// One block: split blockIdx.x of (row b = blockIdx.z, head h =
// blockIdx.y); LPK lanes own a key (a power of two, at least D's 16-byte
// chunks).
template <typename TQ, int LPK>
__global__ void __launch_bounds__(QD_THREADS)
    paged_quant_decode_split_kernel(
        const TQ* __restrict__ q, const int8_t* __restrict__ k_pool,
        const int8_t* __restrict__ v_pool, const float* __restrict__ k_scale,
        const float* __restrict__ v_scale, const int* __restrict__ lengths,
        const int* __restrict__ tables, TQ* __restrict__ out,
        float* __restrict__ parts, int* __restrict__ counters, int H, int D,
        int bs, int M, float scale) {
  paged_split_decode<SPLIT, QD_THREADS, LPK>(
      Int8Pool<TQ>{k_pool, v_pool, k_scale, v_scale}, q, lengths, tables,
      out, parts, counters, H, D, bs, M, scale);
}

template <typename TQ, int LPK>
cudaError_t launch_lpk(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const int* lengths,
                       const int* tables, void* out, void* parts,
                       void* counters, int B, int H, int D, int bs, int M,
                       float scale, cudaStream_t stream) {
  const size_t smem = paged_split_stage_bytes<SPLIT, Int8Pool<TQ>>(D);
  auto kernel = paged_quant_decode_split_kernel<TQ, LPK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M * bs + SPLIT - 1) / SPLIT, H, B);
  kernel<<<grid, QD_THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), lengths, tables, static_cast<TQ*>(out),
      static_cast<float*>(parts), static_cast<int*>(counters), H, D, bs, M,
      scale);
  record_grid(grid);
  return cudaGetLastError();
}

// The lanes a key takes: D's 16-byte chunks rounded up to 4 or 8.
template <typename TQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const int* lengths,
                   const int* tables, void* out, void* parts, void* counters,
                   int B, int H, int D, int bs, int M, float scale,
                   cudaStream_t stream) {
  if (D / Int8Pool<TQ>::VEC <= 4)
    return launch_lpk<TQ, 4>(q, k, v, ks, vs, lengths, tables, out, parts,
                             counters, B, H, D, bs, M, scale, stream);
  return launch_lpk<TQ, 8>(q, k, v, ks, vs, lengths, tables, out, parts,
                           counters, B, H, D, bs, M, scale, stream);
}

}  // namespace
}  // namespace nezha

// The keys a block folds: the wrapper sizes the workspace from it.
extern "C" int nezha_paged_quant_decode_split() { return nezha::SPLIT; }

// Writes the grid (x, y, z) of the last kernel nezha_paged_quant_decode
// launched from this library into xyz[3]; zeros before the first.
// Returns 0.
extern "C" int nezha_paged_quant_decode_last_grid(int* xyz) {
  for (int i = 0; i < 3; ++i) xyz[i] = nezha::last_grid[i];
  return 0;
}

// q [B, H, 1, D] f32 or bf16; k_pool/v_pool [N, H, bs, D] int8; k_scale/
// v_scale [N, H] f32; lengths [B] int32; tables [B, M] int32; out
// [B, H, 1, D] of q's dtype. All contiguous, on the current device, D a
// multiple of 16 up to 128, pools 16-byte aligned. parts: fp32 workspace
// of B * H * ceil(M * bs / split) * (D + 2) floats; counters: [B * H]
// int32, zero before the first call (each call leaves them zero). Calls
// that share counters must run in order (one stream). Returns the
// cudaError_t of the launch (0 = queued).
extern "C" int nezha_paged_quant_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* lengths,
    const void* tables, void* out, int B, int H, int D, int bs, int M,
    float scale, int q_dtype, void* stream, void* parts, void* counters) {
  if (B <= 0 || H <= 0 || D <= 0 || D > nezha::MAX_D || D % 16 || bs <= 0 ||
      M <= 0 || parts == nullptr || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (q_dtype == nezha::BF16)
    return nezha::launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                        len, tab, out, parts, counters, B, H,
                                        D, bs, M, scale, s);
  if (q_dtype == nezha::F32)
    return nezha::launch<float>(q, k_pool, v_pool, k_scale, v_scale, len,
                                tab, out, parts, counters, B, H, D, bs, M,
                                scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
