// The split walk the paged decode kernels share: the float paged decode
// (paged_decode.cu, B7) and the int8 paged decode (paged_quant_decode.cu,
// B8) differ only in what a pool holds, which a tile source gives:
//   - Elem and VEC: the pool's element type and the elements of a 16-byte
//     chunk;
//   - SCALED: whether a pool block carries a K and a V scale per head
//     (k_scale/v_scale [N, H], staged once per pool block of the split);
//   - q_value(q): q as the dots take it; p_value(p): p as P.V takes it;
//     value(e, s): a pool element as the dots take it, s its block's
//     scale where SCALED;
//   - k, v (and k_scale, v_scale where SCALED): the pools.
//
// One block: split blockIdx.x of (row b = blockIdx.z, head h =
// blockIdx.y), SPLIT keys. A block whose split starts at or past its
// row's length (clamped to [0, M*bs]) loads nothing and leaves at once;
// split 0 of a length-0 row stays to write its zeros. The split reads
// its pool blocks' table entries once into shared memory, then copies its
// keys' K rows, then their V rows, into shared memory with cp.async in
// two groups in the pool's element type (V still in flight while the
// scores and the softmax run), zeros past its keys. LPK lanes own a key,
// one 16-byte chunk of its row each; the block's P = THREADS / LPK key
// groups take keys g, g + P, ... of the split. Scores are q.k * scale,
// NEG_BIG past the keys; the split's max m, p = exp(s - m) (p_value'd for
// P.V, unrounded into l), the fp32 P.V sums added over the key groups of
// a warp and then the warps in a fixed order, and the partial (acc, m, l)
// merged by arrive_and_merge (split_decode.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_decode.cuh"

namespace nezha {

// The dynamic shared memory of a block: the split's K rows, then its V
// rows, in the pool's element type.
template <int SPLIT, typename Src>
inline size_t paged_split_stage_bytes(int D) {
  return 2 * static_cast<size_t>(SPLIT) * D * sizeof(typename Src::Elem);
}

// The body of a paged split decode kernel: called by all THREADS threads
// of its block, with the kernel's arguments.
template <int SPLIT, int THREADS, int LPK, typename Src, typename TQ>
__device__ __forceinline__ void paged_split_decode(
    const Src& src, const TQ* q, const int* lengths, const int* tables,
    TQ* out, float* parts, int* counters, int H, int D, int bs, int M,
    float scale) {
  using Elem = typename Src::Elem;
  constexpr int VEC = Src::VEC;
  constexpr int WARPS = THREADS / WARP;
  constexpr int P = THREADS / LPK;      // keys in flight a pass
  constexpr int KPT = SPLIT / P;        // keys a thread owns
  constexpr int NSC = Src::SCALED ? SPLIT : 1;
  __shared__ float s_sm[SPLIT];                   // scores, then p
  __shared__ float acc_sm[WARPS][MAX_D];          // warps' P.V sums
  __shared__ float red_sm[2 * WARPS];
  __shared__ int blk_sm[SPLIT];                   // the split's pool blocks
  __shared__ float ks_sm[NSC], vs_sm[NSC];        // and their scales
  __shared__ int last_sm;
  extern __shared__ __align__(16) unsigned char kv_raw[];
  Elem* k_sm = reinterpret_cast<Elem*>(kv_raw);   // [SPLIT][D]
  Elem* v_sm = k_sm + SPLIT * D;                  // [SPLIT][D]

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int tid = threadIdx.x;
  const int warp = tid / WARP, lane = tid % WARP;
  const int grp = tid / LPK, sub = tid % LPK;
  const int cpr = D / VEC;                        // 16-byte chunks a row
  const bool owns = sub < cpr;                    // this lane's chunk

  // q as the dots take it, loaded beside the length: it does not depend
  // on it. Zero on lanes past the row's chunks.
  float qf[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    qf[e] = owns ? src.q_value(q[bh * D + sub * VEC + e]) : 0.f;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > M * bs ? M * bs : len);
  // The splits with keys arrive at the merge; an empty row's split 0
  // arrives alone and writes zeros. The rest have nothing to do.
  const int n_live = (len + SPLIT - 1) / SPLIT;
  const int arrivals = n_live > 0 ? n_live : 1;
  if (split >= arrivals) return;
  const int s0 = split * SPLIT;
  const int n = max(0, min(SPLIT, len - s0));     // this split's keys

  if (n > 0) {
    // The table entries of the pool blocks the split touches, once.
    const int first = s0 / bs;
    const int nb = (s0 + n - 1) / bs - first + 1;
    for (int i = tid; i < nb; i += THREADS)
      blk_sm[i] = tables[static_cast<size_t>(b) * M + first + i];
    __syncthreads();
    // Element offset in a pool of the row of key j (< n) of the split.
    auto row_of = [&](int j) {
      const int p = s0 + j;
      return ((static_cast<size_t>(blk_sm[p / bs - first]) * H + h) * bs +
              p % bs) * D;
    };
    // The keys' rows into shared memory, K then V in two groups; zeros
    // past the split's keys, which load nothing.
    for (int c = tid; c < SPLIT * cpr; c += THREADS) {
      const int j = c / cpr, col = (c - j * cpr) * VEC;
      cp_async16(k_sm + j * D + col, src.k + (j < n ? row_of(j) + col : 0),
                 j < n ? 16 : 0);
    }
    cp_async_commit();
    for (int c = tid; c < SPLIT * cpr; c += THREADS) {
      const int j = c / cpr, col = (c - j * cpr) * VEC;
      cp_async16(v_sm + j * D + col, src.v + (j < n ? row_of(j) + col : 0),
                 j < n ? 16 : 0);
    }
    cp_async_commit();
    if constexpr (Src::SCALED) {
      // One K and one V scale per pool block, while the rows are in
      // flight.
      for (int i = tid; i < nb; i += THREADS) {
        const size_t si = static_cast<size_t>(blk_sm[i]) * H + h;
        ks_sm[i] = src.k_scale[si];
        vs_sm[i] = src.v_scale[si];
      }
    }
    cp_async_wait<1>();   // this thread's K rows
    __syncthreads();

    // Scores: each lane takes its chunk of its keys' K rows and dots it
    // with q's chunk, then the key's LPK lanes add their parts.
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = grp + P * i;
      float dot = 0.f;
      if (owns) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(k_sm + j * D + sub * VEC);
        const Elem* kv = reinterpret_cast<const Elem*>(&raw);
        float ksc = 0.f;
        if constexpr (Src::SCALED)
          ksc = j < n ? ks_sm[(s0 + j) / bs - first] : 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dot = fmaf(qf[e], src.value(kv[e], ksc), dot);
      }
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (sub == 0) s_sm[j] = j < n ? dot * scale : NEG_BIG;
    }
    __syncthreads();

    // The split's max, then p = exp(s - m) (p_value'd for P.V, unrounded
    // into l), as one block step.
    float mx = NEG_BIG;
    for (int j = tid; j < SPLIT; j += THREADS) mx = fmaxf(mx, s_sm[j]);
    mx = warp_max(mx);
    if (lane == 0) red_sm[warp] = mx;
    __syncthreads();
    float m = red_sm[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red_sm[w]);
    float lsum = 0.f;
    for (int j = tid; j < SPLIT; j += THREADS) {
      const float p = expf(s_sm[j] - m);
      lsum += p;
      s_sm[j] = src.p_value(p);
    }
    lsum = warp_sum(lsum);
    if (lane == 0) red_sm[WARPS + warp] = lsum;
    cp_async_wait<0>();   // this thread's V rows
    __syncthreads();
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l += red_sm[WARPS + w];

    // P.V: each thread sums p_j v_j over its keys for its chunk (p and V
    // are zero past the split's keys), then the key groups of a warp,
    // then the warps, in a fixed order.
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    if (owns) {
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int j = grp + P * i;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(v_sm + j * D + sub * VEC);
        const Elem* vv = reinterpret_cast<const Elem*>(&raw);
        float vsc = 0.f;
        if constexpr (Src::SCALED)
          vsc = j < n ? vs_sm[(s0 + j) / bs - first] : 0.f;
        const float p = s_sm[j];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = fmaf(p, src.value(vv[e], vsc), acc[e]);
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
    for (int d = tid; d < D; d += THREADS) {
      float a = acc_sm[0][d];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) a += acc_sm[w][d];
      part[d] = a;
    }
    if (tid == 0) {
      part[D] = m;
      part[D + 1] = l;
    }
  }

  arrive_and_merge<THREADS>(parts + bh * n_splits * part_floats(D),
                            counters, out, bh, arrivals, n_live, D, last_sm);
}

}  // namespace nezha
