// Dense flash-decode for Hopper (sm_90a), split over the KV length.
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
// What bounds it: bytes. A call must read the K and V positions below
// every row's length once (sum_b lengths[b] * H * D * 2 * sizeof(cache))
// and does 4 flops per element read, far below the ~295 flop/byte where
// the tensor cores would be the limit. At generate's shape (B=8, H=12,
// D=64) one block per (row, head) gives 96 blocks for 132 SMs, so the
// design is about enough loads in flight:
//   - the split: each row's positions [0, len) are cut into splits of
//     SPLIT keys, a fixed compile-time size (timed on the card), and the
//     grid is (splits of L, H, B): 768 blocks at L=1024. A block whose
//     split starts at or past the row's length loads nothing. The split
//     never depends on the lengths, which live on the device, so the host
//     never syncs and the result never depends on timing;
//   - staging in the cache dtype: LPK lanes own a key, one 16-byte chunk
//     of its row each. A thread issues the loads of its keys' K chunks
//     into registers, then cp.async copies of their V chunks into shared
//     memory, before it uses any, so the split's K and V are in flight
//     together while the scores and the softmax run. A block needs
//     SPLIT * D of the cache dtype in shared memory (16 KB at D=64, bf16,
//     128 keys) and several fit on an SM. (V in registers, loaded after
//     the softmax or beside K, timed no faster on the H100: PERF.md.);
//   - the merge (split_decode.cuh, shared with the int8 paged kernel):
//     each split writes its partial (m, l, acc[D]) in fp32 to a workspace
//     the wrapper allocates; the last block of a (b, h) to finish, found
//     by a per-(b, h) counter that it resets to 0, merges the row's splits
//     in split order, so the output is bitwise the same from run to run.
//     One launch a call.
//
// Semantics of the TPU's block step (ops/pallas/common.py:86-98), a split
// being one block: q is rounded to the cache dtype before Q.K, p to v's
// dtype before P.V, the statistics and the accumulator are fp32, masked
// keys score NEG_BIG.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"
#include "split_decode.cuh"

namespace nezha {
namespace {

constexpr int SPLIT = 128;                  // keys a block folds
constexpr int DEC_THREADS = 128;            // 4 warps
constexpr int DEC_WARPS_SPLIT = DEC_THREADS / WARP;
constexpr int UNROLL = 8;                   // keys a thread loads at once

// The dynamic shared memory of a block: the split's V rows.
inline size_t v_stage_bytes(int D, int elem_bytes) {
  return static_cast<size_t>(SPLIT) * D * elem_bytes;
}

// One block: split blockIdx.x of (row b = blockIdx.z, head h =
// blockIdx.y). LPK lanes own a key (a power of two, at least D's 16-byte
// chunks); the block's P = DEC_THREADS / LPK key groups take keys g,
// g + P, ... of the split.
template <typename TQ, typename TKV, int LPK>
__global__ void __launch_bounds__(DEC_THREADS)
    flash_decode_split_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ k,
                              const TKV* __restrict__ v,
                              const int* __restrict__ lengths,
                              TQ* __restrict__ out,
                              float* __restrict__ parts,
                              int* __restrict__ counters, int H, int L,
                              int D, float scale) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(TKV));
  constexpr int P = DEC_THREADS / LPK;      // keys in flight a pass
  constexpr int KPT = SPLIT / P;            // keys a thread owns
  constexpr int U = KPT < UNROLL ? KPT : UNROLL;
  static_assert(KPT % U == 0, "whole load rounds");
  __shared__ float s_sm[SPLIT];                        // scores, then p
  __shared__ float acc_sm[DEC_WARPS_SPLIT][MAX_D];     // warps' P.V sums
  __shared__ float red_sm[2 * DEC_WARPS_SPLIT];
  __shared__ int last_sm;
  extern __shared__ __align__(16) unsigned char v_raw[];
  TKV* v_sm = reinterpret_cast<TKV*>(v_raw);          // [SPLIT][D]

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int s0 = split * SPLIT;
  const int n = max(0, min(SPLIT, len - s0));   // this split's keys
  const int tid = threadIdx.x;
  const int warp = tid / WARP, lane = tid % WARP;
  const int grp = tid / LPK, sub = tid % LPK;
  const int cpr = D / VEC;                      // 16-byte chunks a row
  const bool owns = sub < cpr;                  // this lane's chunk

  if (n > 0) {
    // q rounded to the cache dtype (block_step's cast before Q.K); zero
    // on lanes past the row's chunks.
    float qf[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qf[e] = owns ? round_to<TKV>(to_float(q[bh * D + sub * VEC + e])) : 0.f;
    const TKV* kh = k + (bh * L + s0) * D + sub * VEC;
    const TKV* vh = v + (bh * L + s0) * D + sub * VEC;

    // Scores: each thread loads its U keys' chunks, then reduces the
    // partial dots over the key's LPK lanes.
    for (int i0 = 0; i0 < KPT; i0 += U) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = grp + P * (i0 + u);
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (owns && j < n)
          raw[u] = *reinterpret_cast<const uint4*>(
              kh + static_cast<size_t>(j) * D);
      }
      if (i0 == 0) {
        // Behind the first K loads, V of this thread's keys into shared
        // memory, zeros past the split's keys; waited for before P.V.
        if (owns) {
          for (int i = 0; i < KPT; ++i) {
            const int j = grp + P * i;
            cp_async16(v_sm + j * D + sub * VEC,
                       vh + static_cast<size_t>(j < n ? j : 0) * D,
                       j < n ? 16 : 0);
          }
        }
        cp_async_commit();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const TKV* kv = reinterpret_cast<const TKV*>(&raw[u]);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qf[e], to_float(kv[e]), dot);
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const int j = grp + P * (i0 + u);
        if (sub == 0) s_sm[j] = j < n ? dot * scale : NEG_BIG;
      }
    }
    __syncthreads();

    // The split's max, then p = exp(s - m) (rounded to v's dtype for
    // P.V, unrounded into l), as one block step.
    float mx = NEG_BIG;
    for (int j = tid; j < SPLIT; j += DEC_THREADS) mx = fmaxf(mx, s_sm[j]);
    mx = warp_max(mx);
    if (lane == 0) red_sm[warp] = mx;
    __syncthreads();
    float m = red_sm[0];
#pragma unroll
    for (int w = 1; w < DEC_WARPS_SPLIT; ++w) m = fmaxf(m, red_sm[w]);
    float lsum = 0.f;
    for (int j = tid; j < SPLIT; j += DEC_THREADS) {
      const float p = expf(s_sm[j] - m);
      lsum += p;
      s_sm[j] = round_to<TKV>(p);
    }
    lsum = warp_sum(lsum);
    if (lane == 0) red_sm[DEC_WARPS_SPLIT + warp] = lsum;
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // this thread's V
    __syncthreads();
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS_SPLIT; ++w) l += red_sm[DEC_WARPS_SPLIT + w];

    // P.V: each thread sums p_j v_j over its keys for its chunk (p and V
    // are zero past the split's keys), then the key groups of a warp,
    // then the warps, in a fixed order.
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    if (owns) {
#pragma unroll 4
      for (int i = 0; i < KPT; ++i) {
        const int j = grp + P * i;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(v_sm + j * D + sub * VEC);
        const TKV* vv = reinterpret_cast<const TKV*>(&raw);
        const float p = s_sm[j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, to_float(vv[e]), acc[e]);
      }
    }
#pragma unroll
    for (int o = LPK; o < WARP; o <<= 1)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    if (lane < LPK && owns) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_sm[warp][sub * VEC + e] = acc[e];
    }
    __syncthreads();
    float* part = parts + (bh * n_splits + split) * part_floats(D);
    for (int d = tid; d < D; d += DEC_THREADS) {
      float a = acc_sm[0][d];
#pragma unroll
      for (int w = 1; w < DEC_WARPS_SPLIT; ++w) a += acc_sm[w][d];
      part[d] = a;
    }
    if (tid == 0) {
      part[D] = m;
      part[D + 1] = l;
    }
  }

  arrive_and_merge<DEC_THREADS>(parts + bh * n_splits * part_floats(D),
                                counters, out, bh, n_splits,
                                (len + SPLIT - 1) / SPLIT, D, last_sm);
}

template <typename TQ, typename TKV, int LPK>
cudaError_t launch_lpk(const void* q, const void* k, const void* v,
                       const int* lengths, void* out, void* parts,
                       void* counters, int B, int H, int L, int D,
                       float scale, cudaStream_t stream) {
  const size_t smem = v_stage_bytes(D, sizeof(TKV));
  auto kernel = flash_decode_split_kernel<TQ, TKV, LPK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + SPLIT - 1) / SPLIT, H, B);
  kernel<<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), lengths, static_cast<TQ*>(out),
      static_cast<float*>(parts), static_cast<int*>(counters), H, L, D,
      scale);
  record_grid(grid);
  return cudaGetLastError();
}

// The lanes a key takes: D's 16-byte chunks rounded up to 8, 16 or 32.
template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, void* parts,
                   void* counters, int B, int H, int L, int D, float scale,
                   cudaStream_t stream) {
  const int cpr = D * static_cast<int>(sizeof(TKV)) / 16;
  if (cpr <= 8)
    return launch_lpk<TQ, TKV, 8>(q, k, v, lengths, out, parts, counters, B,
                                  H, L, D, scale, stream);
  if (cpr <= 16)
    return launch_lpk<TQ, TKV, 16>(q, k, v, lengths, out, parts, counters,
                                   B, H, L, D, scale, stream);
  return launch_lpk<TQ, TKV, 32>(q, k, v, lengths, out, parts, counters, B,
                                 H, L, D, scale, stream);
}

}  // namespace
}  // namespace nezha

// The keys a block folds: the wrapper sizes the workspace from it.
extern "C" int nezha_flash_decode_split() { return nezha::SPLIT; }

// Writes the grid (x, y, z) of the last kernel nezha_flash_decode launched
// from this library into xyz[3]; zeros before the first. Returns 0.
extern "C" int nezha_flash_decode_last_grid(int* xyz) {
  for (int i = 0; i < 3; ++i) xyz[i] = nezha::last_grid[i];
  return 0;
}

// q [B, H, 1, D]; k/v [B, H, L, D]; lengths [B] int32; out [B, H, 1, D] of
// q's dtype. All contiguous, on the current device. parts: fp32
// workspace of B * H * ceil(L / split) * (D + 2) floats; counters: [B * H]
// int32, zero before the first call (each call leaves them zero). Calls
// that share counters must run in order (one stream). Returns the
// cudaError_t of the launch (0 = queued).
extern "C" int nezha_flash_decode(const void* q, const void* k,
                                  const void* v, const void* lengths,
                                  void* out, int B, int H, int L, int D,
                                  float scale, int q_dtype, int kv_dtype,
                                  void* stream, void* parts, void* counters) {
  using nezha::BF16;
  using nezha::F32;
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0 || D > nezha::MAX_D || D % 8 ||
      parts == nullptr || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (q_dtype == BF16 && kv_dtype == BF16)
    return nezha::launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, len, out, parts, counters, B, H, L, D, scale, s);
  if (q_dtype == F32 && kv_dtype == BF16)
    return nezha::launch<float, __nv_bfloat16>(q, k, v, len, out, parts,
                                               counters, B, H, L, D, scale,
                                               s);
  if (q_dtype == BF16 && kv_dtype == F32)
    return nezha::launch<__nv_bfloat16, float>(q, k, v, len, out, parts,
                                               counters, B, H, L, D, scale,
                                               s);
  if (q_dtype == F32 && kv_dtype == F32)
    return nezha::launch<float, float>(q, k, v, len, out, parts, counters, B,
                                       H, L, D, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
