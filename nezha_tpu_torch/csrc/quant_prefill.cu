// Paged flash-prefill over an int8 KV pool, with the chunk's int8 block
// write fused into the call, for Hopper (sm_90a).
//
// Replaces: nezha_tpu/ops/pallas/prefill_attention.py:
// _quant_prefill_kernel (with _quant_merge_write), reached from
// models/gpt2.py Attention._apply_paged on each prefill chunk an int8
// engine (ServeConfig.kv_dtype="int8") dispatches.
//
// Computes, per row b with start = starts[b] (clamped to [0, M*bs]):
//   1. attention: query i of the chunk sits at position start + i and
//      attends the row's int8 prefix [0, start) through block_tables[b],
//      each position dequantized with its (block, head) scale and rounded
//      to q's dtype, then the chunk's own k_chunk/v_chunk causally, as
//      they are (in q's dtype: unlike the float kernel, nothing is routed
//      through the pool dtype). Dots in q's dtype, p rounded to q's
//      dtype, statistics and accumulator fp32;
//   2. the write: every block t in [start/bs, (start+S-1)/bs] (t < M) the
//      chunk touches, per head, becomes the merge of its old content below
//      start (int8 * old scale in fp32, not rounded to q's dtype), the
//      chunk's values in [start, start+S) (pad tokens of a bucketed chunk
//      included) and zeros after them (a freshly bound block's stale int8
//      must not set the absmax), sanitized, requantized with a fresh scale
//      (kv_quant.cuh) and written with it into the pool in place;
//   3. qerr: the max over rows, heads and touched blocks of |merged -
//      q * scale| over positions below start + S, the old ones included.
// The scratch block 0 is never written.
//
// The ordering hazard. Every query tile of a (row, head) reads block
// start/bs below start, and the write rewrites that whole block (its old
// positions re-round when the absmax moves). The TPU kernel's sequential
// grid wrote only in its last query-tile sweep, after every read. Here the
// query tiles run at once, so the two steps are two grids launched by the
// same C entry point on the same stream: the write grid starts only after
// every block of the attention grid has finished reading. Rows of one call
// must not share touched blocks (prefix blocks are only read and may be
// shared); the serve engine prefills one row per call.
//
// What bounds it: at the engine's shapes (one row, S up to 256, prefixes up
// to ~1k positions, D=64) bytes: 4 * S * (start + S/2) * D flops per head
// against (start + S) * D int8 K and V plus the chunk in q's dtype, about
// 256 flop/byte at S=256, below the ~295 flop/byte bf16 ridge. The
// attention grid is the float kernel's fold (prefill_fold.cuh: 64-key
// tiles split over the 8 warps of a block, Q.K^T and P.V on the tensor
// cores for a bf16 q, on the FMA pipes for an fp32 one); each prefix tile
// is dequantized to q's dtype as it is staged, so the shared tile holds
// bf16 on the main path. The write grid is one block per (touched block, head,
// row): two passes over bs*D elements (absmax, then quantize and store),
// with block-wide max reductions. qerr is a float max taken with an
// integer atomicMax on its bits (every err is >= 0), which does not depend
// on order; the attention grid zeroes it first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_quant.cuh"
#include "prefill_fold.cuh"

namespace nezha {
namespace {

constexpr int WR_THREADS = 256;

__device__ __forceinline__ int clamp_start(int start, int cap) {
  return start < 0 ? 0 : (start > cap ? cap : start);
}

template <typename TQ, int ND>
__global__ void __launch_bounds__(prefill::THREADS)
    quant_prefill_attn_kernel(const TQ* __restrict__ q,
                              const TQ* __restrict__ k_chunk,
                              const TQ* __restrict__ v_chunk,
                              const int8_t* __restrict__ k_pool,
                              const int8_t* __restrict__ v_pool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ tables,
                              const int* __restrict__ starts,
                              TQ* __restrict__ out, float* __restrict__ qerr,
                              int H, int S, int D, int bs, int M,
                              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;

  // The write grid, launched after this one, maxes into qerr.
  if (blockIdx.x == 0 && h == 0 && b == 0 && threadIdx.x == 0) *qerr = 0.f;

  const int start = clamp_start(starts[b], M * bs);
  const int* tab = tables + static_cast<size_t>(b) * M;
  auto scale_at = [=](int p) {
    return static_cast<size_t>(tab[p / bs]) * H + h;
  };
  // The int8 prefix, each position times its (block, head) scale, rounded
  // to q's dtype.
  auto prefix = prefill::tiles<TQ, ND, prefill::Dequant<TQ>>(
      k_pool, v_pool, [=](int p) { return (scale_at(p) * bs + p % bs) * D; },
      [=](int p) { return k_scale[scale_at(p)]; },
      [=](int p) { return v_scale[scale_at(p)]; });
  // The chunk as given, in q's dtype.
  auto chunk = prefill::tiles<TQ, ND, prefill::Copy>(
      k_chunk + bh * S * D, v_chunk + bh * S * D,
      [=](int c) { return static_cast<size_t>(c) * D; });
  prefill::prefill_rows<TQ, TQ, ND>(smem, q + bh * S * D, out + bh * S * D,
                                    S, S, 0, start, D, scale, prefix, chunk);
}

// Max of x over the block; every thread gets it. red holds one float per
// warp; the trailing barrier lets the caller reuse it.
__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  if (threadIdx.x % WARP == 0) red[threadIdx.x / WARP] = x;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < WR_THREADS / WARP; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

template <typename TQ>
__global__ void __launch_bounds__(WR_THREADS)
    quant_prefill_write_kernel(const TQ* __restrict__ k_chunk,
                               const TQ* __restrict__ v_chunk,
                               int8_t* __restrict__ k_pool,
                               int8_t* __restrict__ v_pool,
                               float* __restrict__ k_scale,
                               float* __restrict__ v_scale,
                               const int* __restrict__ tables,
                               const int* __restrict__ starts,
                               float* __restrict__ qerr, int H, int S, int D,
                               int bs, int M) {
  __shared__ float red[WR_THREADS / WARP];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int start = clamp_start(starts[b], M * bs);
  const int t = start / bs + blockIdx.x;
  if (t > (start + S - 1) / bs || t >= M) return;   // the whole block
  const size_t sidx = static_cast<size_t>(tables[static_cast<size_t>(b) * M +
                                                 t]) * H + h;
  const size_t base = sidx * bs * D;               // the (block, head) tile
  const size_t chunk = (static_cast<size_t>(b) * H + h) * S * D;
  const int p0 = t * bs;                           // its first position
  const int n = bs * D;
  float err = 0.f;
#pragma unroll 1
  for (int kv = 0; kv < 2; ++kv) {
    const TQ* src = kv ? v_chunk : k_chunk;
    int8_t* pool = kv ? v_pool : k_pool;
    float* scales = kv ? v_scale : k_scale;
    const float old_scale = scales[sidx];
    // Element e of the merged block. Each element is read and written by
    // one thread only, and the old scale is read before the barrier in
    // block_max that precedes its overwrite.
    auto merged = [&](int e) {
      const int p = p0 + e / D;
      float x = 0.f;
      if (p < start)
        x = __fmul_rn(static_cast<float>(pool[base + e]), old_scale);
      else if (p < start + S)
        x = to_float(src[chunk + static_cast<size_t>(p - start) * D + e % D]);
      return sanitize(x);
    };
    float amax = 0.f;
    for (int e = threadIdx.x; e < n; e += WR_THREADS)
      amax = fmaxf(amax, fabsf(merged(e)));
    const float sc = quant_scale(block_max(amax, red));
    for (int e = threadIdx.x; e < n; e += WR_THREADS) {
      const float x = merged(e);
      const float qv = quantize(x, sc);
      if (p0 + e / D < start + S)
        err = fmaxf(err, fabsf(__fsub_rn(x, __fmul_rn(qv, sc))));
      pool[base + e] = static_cast<int8_t>(qv);
    }
    if (threadIdx.x == 0) scales[sidx] = sc;
  }
  err = block_max(err, red);
  if (threadIdx.x == 0)
    atomicMax(reinterpret_cast<int*>(qerr), __float_as_int(err));
}

template <typename TQ, int ND>
cudaError_t launch_attn(const void* q, const void* kc, const void* vc,
                        const void* kp, const void* vp, const void* ks,
                        const void* vs, const int* tables, const int* starts,
                        void* out, float* qerr, int B, int H, int S, int D,
                        int bs, int M, float scale, cudaStream_t stream) {
  using Plan = prefill::Plan<TQ, TQ, int8_t, ND>;
  const size_t smem = Plan::smem_bytes(D);
  auto attn = quant_prefill_attn_kernel<TQ, ND>;
  cudaError_t err = flash::prepare(attn, smem);
  if (err != cudaSuccess) return err;
  attn<<<dim3((S + Plan::QT - 1) / Plan::QT, H, B), prefill::THREADS, smem,
         stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(kc),
      static_cast<const TQ*>(vc), static_cast<const int8_t*>(kp),
      static_cast<const int8_t*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), tables, starts, static_cast<TQ*>(out),
      qerr, H, S, D, bs, M, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* kp,
                   void* vp, void* ks, void* vs, const int* tables,
                   const int* starts, void* out, float* qerr, int B, int H,
                   int S, int D, int bs, int M, float scale,
                   cudaStream_t stream) {
  // The accumulator holds D / 8 column groups: 8 up to D = 64, else 16.
  cudaError_t err =
      D <= 64 ? launch_attn<TQ, 8>(q, kc, vc, kp, vp, ks, vs, tables, starts,
                                   out, qerr, B, H, S, D, bs, M, scale,
                                   stream)
              : launch_attn<TQ, 16>(q, kc, vc, kp, vp, ks, vs, tables,
                                    starts, out, qerr, B, H, S, D, bs, M,
                                    scale, stream);
  if (err != cudaSuccess) return err;
  // Touched blocks per row: at most (S - 1) / bs + 2, when start is not
  // block-aligned; the grid's spare blocks return at once.
  const int touched = (S - 1) / bs + 2 < M ? (S - 1) / bs + 2 : M;
  quant_prefill_write_kernel<TQ><<<dim3(touched, H, B), WR_THREADS, 0,
                                   stream>>>(
      static_cast<const TQ*>(kc), static_cast<const TQ*>(vc),
      static_cast<int8_t*>(kp), static_cast<int8_t*>(vp),
      static_cast<float*>(ks), static_cast<float*>(vs), tables, starts, qerr,
      H, S, D, bs, M);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nezha

// q/k_chunk/v_chunk [B, H, S, D] of one dtype (f32 or bf16); k_pool/v_pool
// [N, H, bs, D] int8 and k_scale/v_scale [N, H] f32, updated in place;
// tables [B, M] int32; starts [B] int32; out [B, H, S, D] of q's dtype;
// qerr one f32. All contiguous, on the current device, D a multiple of 16.
// Launches the attention grid, then the write grid, on `stream`. Returns
// the first failing launch's cudaError_t (0 = both queued).
extern "C" int nezha_quant_prefill(const void* q, const void* k_chunk,
                                   const void* v_chunk, void* k_pool,
                                   void* v_pool, void* k_scale,
                                   void* v_scale, const void* tables,
                                   const void* starts, void* out, void* qerr,
                                   int B, int H, int S, int D, int bs, int M,
                                   float scale, int q_dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > nezha::MAX_D || D % 16 ||
      bs <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tab = static_cast<const int*>(tables);
  const int* st = static_cast<const int*>(starts);
  float* err = static_cast<float*>(qerr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (q_dtype == nezha::BF16)
    return nezha::launch<__nv_bfloat16>(q, k_chunk, v_chunk, k_pool, v_pool,
                                        k_scale, v_scale, tab, st, out, err,
                                        B, H, S, D, bs, M, scale, s);
  if (q_dtype == nezha::F32)
    return nezha::launch<float>(q, k_chunk, v_chunk, k_pool, v_pool, k_scale,
                                v_scale, tab, st, out, err, B, H, S, D, bs, M,
                                scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
