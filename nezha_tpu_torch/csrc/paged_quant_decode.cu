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
// below the tensor cores' ridge. One block per (head, row), as the float
// paged kernel runs (decode_fold.cuh), gave 96 blocks for 132 SMs at the
// serving shape (B=8, H=12), 24 on a shard of a 4-way mesh, and one block
// walked the longest row alone. So:
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
//     64 keys; the fp32 tiles of decode_fold.cuh took 134 KB), so several
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
#include "split_decode.cuh"

namespace nezha {
namespace {

constexpr int SPLIT = 64;               // keys a block folds
constexpr int QD_THREADS = 128;         // 4 warps
constexpr int QD_WARPS = QD_THREADS / WARP;
constexpr int QVEC = 16;                // int8 values in a 16-byte chunk

// The dynamic shared memory of a block: the split's int8 K rows, then its
// V rows.
inline size_t kv_stage_bytes(int D) {
  return 2 * static_cast<size_t>(SPLIT) * D;
}

// One block: split blockIdx.x of (row b = blockIdx.z, head h =
// blockIdx.y). LPK lanes own a key (a power of two, at least D's 16-byte
// chunks); the block's P = QD_THREADS / LPK key groups take keys g,
// g + P, ... of the split.
template <typename TQ, int LPK>
__global__ void __launch_bounds__(QD_THREADS)
    paged_quant_decode_split_kernel(
        const TQ* __restrict__ q, const int8_t* __restrict__ k_pool,
        const int8_t* __restrict__ v_pool, const float* __restrict__ k_scale,
        const float* __restrict__ v_scale, const int* __restrict__ lengths,
        const int* __restrict__ tables, TQ* __restrict__ out,
        float* __restrict__ parts, int* __restrict__ counters, int H, int D,
        int bs, int M, float scale) {
  constexpr int P = QD_THREADS / LPK;   // keys in flight a pass
  constexpr int KPT = SPLIT / P;        // keys a thread owns
  __shared__ float s_sm[SPLIT];                   // scores, then p
  __shared__ float acc_sm[QD_WARPS][MAX_D];       // warps' P.V sums
  __shared__ float red_sm[2 * QD_WARPS];
  __shared__ int blk_sm[SPLIT];                   // the split's pool blocks
  __shared__ float ks_sm[SPLIT], vs_sm[SPLIT];    // and their scales
  __shared__ int last_sm;
  extern __shared__ __align__(16) int8_t kv_sm[];
  int8_t* k_sm = kv_sm;                           // [SPLIT][D]
  int8_t* v_sm = kv_sm + SPLIT * D;               // [SPLIT][D]

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int tid = threadIdx.x;
  const int warp = tid / WARP, lane = tid % WARP;
  const int grp = tid / LPK, sub = tid % LPK;
  const int cpr = D / QVEC;                       // 16-byte chunks a row
  const bool owns = sub < cpr;                    // this lane's chunk

  // q as it is (the dots run in its dtype), loaded beside the length: it
  // does not depend on it. Zero on lanes past the row's chunks.
  float qf[QVEC];
#pragma unroll
  for (int e = 0; e < QVEC; ++e)
    qf[e] = owns ? to_float(q[bh * D + sub * QVEC + e]) : 0.f;
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
    for (int i = tid; i < nb; i += QD_THREADS)
      blk_sm[i] = tables[static_cast<size_t>(b) * M + first + i];
    __syncthreads();
    // Element offset in a pool of the row of key j (< n) of the split.
    auto row_of = [&](int j) {
      const int p = s0 + j;
      return ((static_cast<size_t>(blk_sm[p / bs - first]) * H + h) * bs +
              p % bs) * D;
    };
    // The keys' int8 rows into shared memory, K then V in two groups;
    // zeros past the split's keys, which load nothing.
    for (int c = tid; c < SPLIT * cpr; c += QD_THREADS) {
      const int j = c / cpr, col = (c - j * cpr) * QVEC;
      cp_async16(k_sm + j * D + col, k_pool + (j < n ? row_of(j) + col : 0),
                 j < n ? 16 : 0);
    }
    cp_async_commit();
    for (int c = tid; c < SPLIT * cpr; c += QD_THREADS) {
      const int j = c / cpr, col = (c - j * cpr) * QVEC;
      cp_async16(v_sm + j * D + col, v_pool + (j < n ? row_of(j) + col : 0),
                 j < n ? 16 : 0);
    }
    cp_async_commit();
    // One K and one V scale per pool block, while the rows are in flight.
    for (int i = tid; i < nb; i += QD_THREADS) {
      const size_t si = static_cast<size_t>(blk_sm[i]) * H + h;
      ks_sm[i] = k_scale[si];
      vs_sm[i] = v_scale[si];
    }
    cp_async_wait<1>();   // this thread's K rows
    __syncthreads();

    // Scores: each lane dequantizes its chunk of its keys' K rows and
    // dots it with q's chunk, then the key's LPK lanes add their parts.
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = grp + P * i;
      float dot = 0.f;
      if (owns) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(k_sm + j * D + sub * QVEC);
        const int8_t* kq = reinterpret_cast<const int8_t*>(&raw);
        const float ksc = j < n ? ks_sm[(s0 + j) / bs - first] : 0.f;
#pragma unroll
        for (int e = 0; e < QVEC; ++e)
          dot = fmaf(qf[e], dequant<TQ>(kq[e], ksc), dot);
      }
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (sub == 0) s_sm[j] = j < n ? dot * scale : NEG_BIG;
    }
    __syncthreads();

    // The split's max, then p = exp(s - m) (rounded to q's dtype for P.V,
    // unrounded into l), as one block step.
    float mx = NEG_BIG;
    for (int j = tid; j < SPLIT; j += QD_THREADS) mx = fmaxf(mx, s_sm[j]);
    mx = warp_max(mx);
    if (lane == 0) red_sm[warp] = mx;
    __syncthreads();
    float m = red_sm[0];
#pragma unroll
    for (int w = 1; w < QD_WARPS; ++w) m = fmaxf(m, red_sm[w]);
    float lsum = 0.f;
    for (int j = tid; j < SPLIT; j += QD_THREADS) {
      const float p = expf(s_sm[j] - m);
      lsum += p;
      s_sm[j] = round_to<TQ>(p);
    }
    lsum = warp_sum(lsum);
    if (lane == 0) red_sm[QD_WARPS + warp] = lsum;
    cp_async_wait<0>();   // this thread's V rows
    __syncthreads();
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < QD_WARPS; ++w) l += red_sm[QD_WARPS + w];

    // P.V: each thread sums p_j v_j over its keys for its chunk (p and V
    // are zero past the split's keys), then the key groups of a warp,
    // then the warps, in a fixed order.
    float acc[QVEC];
#pragma unroll
    for (int e = 0; e < QVEC; ++e) acc[e] = 0.f;
    if (owns) {
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int j = grp + P * i;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(v_sm + j * D + sub * QVEC);
        const int8_t* vq = reinterpret_cast<const int8_t*>(&raw);
        const float vsc = j < n ? vs_sm[(s0 + j) / bs - first] : 0.f;
        const float p = s_sm[j];
#pragma unroll
        for (int e = 0; e < QVEC; ++e)
          acc[e] = fmaf(p, dequant<TQ>(vq[e], vsc), acc[e]);
      }
    }
#pragma unroll
    for (int o = LPK; o < WARP; o <<= 1)
#pragma unroll
      for (int e = 0; e < QVEC; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    if (lane < LPK && owns) {
#pragma unroll
      for (int e = 0; e < QVEC; ++e) acc_sm[warp][sub * QVEC + e] = acc[e];
    }
    __syncthreads();
    float* part = parts + (bh * n_splits + split) * part_floats(D);
    for (int d = tid; d < D; d += QD_THREADS) {
      float a = acc_sm[0][d];
#pragma unroll
      for (int w = 1; w < QD_WARPS; ++w) a += acc_sm[w][d];
      part[d] = a;
    }
    if (tid == 0) {
      part[D] = m;
      part[D + 1] = l;
    }
  }

  arrive_and_merge<QD_THREADS>(parts + bh * n_splits * part_floats(D),
                               counters, out, bh, arrivals, n_live, D,
                               last_sm);
}

template <typename TQ, int LPK>
cudaError_t launch_lpk(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const int* lengths,
                       const int* tables, void* out, void* parts,
                       void* counters, int B, int H, int D, int bs, int M,
                       float scale, cudaStream_t stream) {
  const size_t smem = kv_stage_bytes(D);
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
  if (D / QVEC <= 4)
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
