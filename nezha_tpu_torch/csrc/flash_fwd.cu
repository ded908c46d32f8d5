// Flash-attention forward for Hopper (sm_90a), the training path.
//
// Replaces: nezha_tpu/ops/pallas/flash_attention.py:_fwd_kernel (built by
// _flash_call), reached from models/gpt2.py Attention (attn_impl "flash",
// which "auto" resolves to) on every layer of every training step, and by
// generate's prompt prefill.
//
// Computes, per (row b, head h, query i): out = softmax(q.K^T * scale) . V
// over the keys j < kv_len[b] (and j <= i when causal), with the online
// softmax of online_softmax.cuh — masked scores at NEG_BIG, fp32 running
// max / denominator / accumulator, p rounded to V's dtype before P.V, the
// output divided by max(l, 1e-30) — and the per-row fp32 logsumexp
// lse = m + log(max(l, 1e-30)) the backward recomputes p from. Key tiles
// above the causal diagonal or wholly past kv_len are skipped; their
// scores would contribute exact zeros, since key 0 is always attended and
// fixes a finite running max first.
//
// What bounds it: at GPT-2's training shape (B=8, H=12, S=1024, D=64,
// causal, bf16) the call does 4 * B * H * D * S^2 / 2 = 12.9 GFLOP
// against 4 * B * H * S * D * 2 = 50 MB of q, k, v and out, ~257
// flop/byte — just under the H100's ~295 flop/byte bf16 ridge, so the
// least time is ~15 us on the memory system and ~13 us on the tensor
// cores.
//
// Two bodies, chosen by dtype in dispatch() — not a fallback: a bf16 call
// the Hopper kernel cannot take fails.
//
// bf16: flash_fwd_wgmma_kernel, warp-specialised. A block owns 64 NC
// queries of one (b, h): a producer warpgroup, of which one thread issues
// TMA loads (Q once, then K and V tiles of BN keys through an ST-stage
// ring on full/empty mbarriers, 128-byte swizzle, zero fill past S and
// past D), and NC consumer warpgroups of 64 queries each. Per key tile a
// consumer runs S = Q.K^T as wgmma m64nBNk16 (Q and K by descriptor),
// the online softmax on the accumulator fragments (4-lane row shuffles,
// in base 2: one FFMA and one ex2 a score), packs P to bf16 in registers
// and runs O += P.V as wgmma with P from registers and V by descriptor
// (transposed). The next tile's S is issued with this tile's P.V, so its
// softmax overlaps P.V on the tensor cores. The mask arithmetic runs only
// on the tile that crosses the diagonal or kv_len. D pads to 64 or 128
// columns (zeros past D: TMA's fill). Under causal the grid launches the
// query tiles with the most key tiles first, over every (b, h), so the
// last wave is the light tiles. The producer gives its registers to the
// consumers (setmaxnreg). The geometry (padded D, NC, BN, ST, shared
// bytes, order) is decided in ops/cuda/flash_attention.py (FWD_BUILDS,
// timed with tools/tune_flash_plans.py: at D <= 64 one consumer, two
// blocks an SM, 128-key tiles, 3 stages; above, two consumers, 3 stages)
// and checked here against the builds in FwdBuilds.
//
// fp32: flash_fwd_kernel, the first version: one block of 4 warps per 64
// queries, the same products on the FMA pipes (wgmma has no fp32
// operands; tf32 would break the fp32 tolerance), tiles staged through
// shared memory with no overlap of load and math.
#include "flash_common.cuh"
#include "hopper.cuh"

#include <tuple>

namespace nezha {
namespace flash {
namespace {

// The fp32 body (see the note at the top).
template <typename T, int ND>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lens,
                     T* __restrict__ out, float* __restrict__ lse, int H,
                     int Sq, int Sk, int D, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld(D);
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + TILE * ld;
  T* vs = ks + TILE * ld;

  const int q0 = blockIdx.x * TILE;
  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int r0 = q0 + warp * ROWS + (lane >> 2);   // this lane's rows r0,
  const int rows[2] = {r0, r0 + 8};                // r0 + 8
  const T* kh = k + bh * Sk * D;
  const T* vh = v + bh * Sk * D;

  const int kv_len = key_limit(lens, b, Sk);
  const int k_end = causal ? min(kv_len, q0 + TILE) : kv_len;
  load_tile(qs, q + bh * Sq * D, q0, Sq, D);

  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float s[NT][4];

  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();
    load_tile(ks, kh, k0, Sk, D);
    load_tile(vs, vh, k0, Sk, D);
    __syncthreads();
    Mma<T>::abt(s, qs + warp * ROWS * ld, ks, D, lane);

    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + frag_col(n, e, lane);
        const bool ok =
            col < kv_len && (!causal || col <= rows[frag_row(e)]);
        s[n][e] = ok ? s[n][e] * scale : NEG_BIG;
        mx[frag_row(e)] = fmaxf(mx[frag_row(e)], s[n][e]);
      }
    }
    float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new[i]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_new[frag_row(e)]);
        sum[frag_row(e)] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
      l[i] = corr[i] * l[i] + sum[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    Mma<T>::template rb<ND>(acc, s, vs, D, lane);
  }

  const float den0 = finalize_denom(l[0]), den1 = finalize_denom(l[1]);
  store_rows<T, ND>(out + bh * Sq * D, acc, r0, Sq, D, lane, den0, den1);
  if ((lane & 3) == 0) {
    if (r0 < Sq) lse[bh * Sq + r0] = finalize_lse(m[0], l[0]);
    if (r0 + 8 < Sq) lse[bh * Sq + r0 + 8] = finalize_lse(m[1], l[1]);
  }
}

template <typename T, int ND>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lens, void* out, float* lse, int B, int H,
                   int Sq, int Sk, int D, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(T) * 3 * TILE * tile_ld(D);
  auto kernel = flash_fwd_kernel<T, ND>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(out), lse, H, Sq, Sk,
      D, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16: wgmma and TMA
// One build of the Hopper body: DP the padded head dim, NC consumer
// warpgroups of 64 queries (a block owns 64 NC queries), BN keys a
// streamed K/V tile holds, ST tiles in flight. A block is a producer
// warpgroup plus the consumers; one block an SM at NC = 2, two at NC = 1.
// A thread starts with 168 registers (NC = 2) or 128 (NC = 1); setmaxnreg
// drops the producer's to 24 and raises the consumers' to 240 or 232.
//
// Shared memory, in bytes from the 1024-aligned base: Q (DP / 64
// sub-tiles of ROWS lines), then per stage a K and a V tile (sub-tiles of
// BN lines), then the barriers q_full, full[stage], empty[stage]. BYTES
// is what the launch asks for: 1024 more, for the alignment. FlashPlan
// (ops/cuda/flash_attention.py) computes the same.
template <int DP_, int NC_, int BN_, int ST_>
struct Fwd {
  static constexpr int DP = DP_, NC = NC_, BN = BN_, ST = ST_;
  static constexpr int ROWS = 64 * NC;
  static constexpr int THREADS = (1 + NC) * hopper::WG_THREADS;
  static constexpr int BLOCKS_PER_SM = NC == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = NC == 1 ? 232 : 240;
  static constexpr int Q_BYTES = ROWS * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;
  static constexpr int K = Q_BYTES;   // stage s: K at K + 2 s KV_BYTES, V after
  static constexpr int BAR = K + ST * 2 * KV_BYTES;
  static constexpr int BYTES = 1024 + BAR + 8 * (1 + 2 * ST);
};

// The builds the entry point can launch, one a padded D (FWD_BUILDS in
// ops/cuda/flash_attention.py); the plan picks one.
using FwdBuilds = std::tuple<Fwd<64, 1, 128, 3>, Fwd<128, 2, 128, 3>>;

// Fold one tile of raw scores s (a consumer's 64 rows by NS * 8 keys
// from k0, the accumulator layout) into the rows' running max m (base 2)
// and sum l: masking to NEG_BIG (key >= kv_len, or past the row's
// diagonal) only when `edge`, the row max taken on the raw scores (scale
// > 0), then s becomes p = 2^(s * scale_log2 - m_new) in place, one FFMA
// and one ex2 an element; corr is what the output accumulator must be
// scaled by. A masked score lands at 2^(NEG_BIG * scale_log2 - m_new) = 0
// once m_new is finite, which the first tile makes it: it holds key 0.
template <int NS>
__device__ __forceinline__ void fold_scores(float (&s)[NS][4], float (&m)[2],
                                            float (&l)[2], float (&corr)[2],
                                            int k0, bool edge, int kv_len,
                                            int causal, const int (&rows)[2],
                                            float scale_log2, int lane) {
  float mx[2] = {NEG_BIG, NEG_BIG};
  if (edge) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + frag_col(n, e, lane);
        const bool ok = col < kv_len && (!causal || col <= rows[frag_row(e)]);
        s[n][e] = ok ? s[n][e] : NEG_BIG;
        mx[frag_row(e)] = fmaxf(mx[frag_row(e)], s[n][e]);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[frag_row(e)] = fmaxf(mx[frag_row(e)], s[n][e]);
    }
  }
  float m_new[2], neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    m_new[i] = fmaxf(m[i], mx[i] * scale_log2);
    neg_m[i] = -m_new[i];
    corr[i] = exp2_approx(m[i] - m_new[i]);
  }
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = exp2_approx(fmaf(s[n][e], scale_log2, neg_m[frag_row(e)]));
      sum[frag_row(e)] += s[n][e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
    sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
    l[i] = corr[i] * l[i] + sum[i];
    m[i] = m_new[i];
  }
}

template <typename C>
__global__ void __launch_bounds__(C::THREADS, C::BLOCKS_PER_SM)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const int* __restrict__ lens,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int H, int Sq, int Sk,
                           int D, float scale_log2, int causal,
                           int heavy_first) {
  using namespace hopper;
  constexpr int DP = C::DP, FW_ROWS = C::ROWS, FW_KEYS = C::BN;
  constexpr int FW_STAGES = C::ST;
  constexpr int SUB = DP / SUB_COLS;   // 64-column sub-tiles
  constexpr int NS = FW_KEYS / 8;      // 8-column groups of a score tile
  constexpr int NO = DP / 8;           // of an output tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + FW_STAGES;

  // Under causal, query tile n_qt - 1 has the most key tiles: rank 0.
  const int n_qt = (Sq + FW_ROWS - 1) / FW_ROWS;
  const int rank = blockIdx.y;
  const int q0 = (causal && heavy_first ? n_qt - 1 - rank : rank) * FW_ROWS;
  const int bh = blockIdx.x;
  const int kv_len = key_limit(lens, bh / H, Sk);
  const int k_end = causal ? min(kv_len, q0 + FW_ROWS) : kv_len;
  const int n_kt = (k_end + FW_KEYS - 1) / FW_KEYS;   // >= 1: kv_len >= 1
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, C::NC * 4);   // each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {   // the producer: one thread issues every load
    regs_release<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < SUB; ++c)
        tma_load_3d(sm + c * FW_ROWS * LINE, &tq, q_full, c * SUB_COLS, q0,
                    bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % FW_STAGES;
        mbar_wait(empty + s, ((j / FW_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * C::KV_BYTES);
        unsigned char* kt = sm + C::K + s * 2 * C::KV_BYTES;
        for (int c = 0; c < SUB; ++c) {
          tma_load_3d(kt + c * FW_KEYS * LINE, &tk, full + s, c * SUB_COLS,
                      j * FW_KEYS, bh);
          tma_load_3d(kt + C::KV_BYTES + c * FW_KEYS * LINE, &tv, full + s,
                      c * SUB_COLS, j * FW_KEYS, bh);
        }
      }
    }
    return;
  }
  regs_claim<C::CONSUMER_REGS>();

  // A consumer: 64 queries; this lane's rows r0 and r0 + 8.
  const int cw = wg - 1;
  const int t = threadIdx.x % WG_THREADS;
  const int warp = t / WARP, lane = t % WARP;
  const int r0 = q0 + 64 * cw + 16 * warp + (lane >> 2);
  const int rows[2] = {r0, r0 + 8};
  const uint32_t q_base = smem_addr(sm) + 64 * cw * LINE;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};   // m in base 2
  float s[NS][4], corr[2];
  uint32_t p[FW_KEYS / 16][4];

  // S = Q . K^T of key tile j into s: 16 columns of D a step, Q and K
  // both K-major. Issued, not waited for.
  auto issue_scores = [&](int j) {
    const int st = j % FW_STAGES;
    mbar_wait(full + st, (j / FW_STAGES) & 1);
    const uint32_t k_base = smem_addr(sm + C::K + st * 2 * C::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      mma_ss<FW_KEYS, 0>(
          s, sw128_desc(q_base + (kk / 4) * FW_ROWS * LINE + col, 16, 1024),
          sw128_desc(k_base + (kk / 4) * FW_KEYS * LINE + col, 16, 1024),
          kk > 0);
    }
    wgmma_commit();
  };
  // Fold the scores of key tile j into (m, l): s becomes p.
  auto fold = [&](int j) {
    fold_scores<NS>(s, m, l, corr, j * FW_KEYS,
                    j * FW_KEYS + FW_KEYS > kv_len ||
                        (causal && j * FW_KEYS + FW_KEYS - 1 > q0),
                    kv_len, causal, rows, scale_log2, lane);
  };
  // P rounded to bf16, packed as the A fragments of P . V.
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < FW_KEYS / 16; ++kk) {
      p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  };

  mbar_wait(q_full, 0);
  fence_acc(s);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  fence_acc(s);
  fold(0);
  pack();
  // Per key tile j: issue S of tile j + 1 and O += P_j . V_j; fold tile
  // j + 1's scores while P_j . V_j runs; then rescale O and pack P_j+1.
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % FW_STAGES;
    const bool more = j + 1 < n_kt;
    const uint32_t v_base =
        smem_addr(sm + C::K + st * 2 * C::KV_BYTES) + C::KV_BYTES;
    fence_acc(s);
    fence_acc(o);
    wgmma_fence();
    if (more) issue_scores(j + 1);
#pragma unroll
    for (int kk = 0; kk < FW_KEYS / 16; ++kk)   // V MN-major (transposed)
      mma_rs<DP, 1>(o, p[kk],
                    sw128_desc(v_base + kk * 16 * LINE, FW_KEYS * LINE, 1024),
                    1);
    wgmma_commit();
    if (more) {
      wgmma_wait<1>();   // the scores of tile j + 1
      fence_acc(s);
      fold(j + 1);
    }
    wgmma_wait<0>();     // P_j . V_j
    fence_acc(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);   // this warp is done with it
    if (more) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      pack();
    }
  }
  const size_t row0 = static_cast<size_t>(bh) * Sq;
  store_rows_bf16x2<NO>(out + row0 * D, o, r0, Sq, D, lane,
                                finalize_denom(l[0]), finalize_denom(l[1]));
  if ((lane & 3) == 0) {
    if (r0 < Sq) lse[row0 + r0] = finalize_lse(m[0] * LN2, l[0]);
    if (r0 + 8 < Sq) lse[row0 + r0 + 8] = finalize_lse(m[1] * LN2, l[1]);
  }
}

template <typename C>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int* lens, void* out, float* lse, int B, int H,
                         int Sq, int Sk, int D, float scale, int causal,
                         int heavy_first, cudaStream_t stream) {
  const int bh = B * H;
  CUtensorMap tq, tk, tv;
  if (!hopper::map_bf16_3d(&tq, q, D, Sq, bh, C::ROWS) ||
      !hopper::map_bf16_3d(&tk, k, D, Sk, bh, C::BN) ||
      !hopper::map_bf16_3d(&tv, v, D, Sk, bh, C::BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<C>;
  cudaError_t err = prepare(kernel, C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (Sq + C::ROWS - 1) / C::ROWS);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(
      tq, tk, tv, lens, static_cast<__nv_bfloat16*>(out), lse, H, Sq, Sk, D,
      scale * LOG2E, causal, heavy_first);
  return cudaGetLastError();
}

// Launch the build of the bf16 body that the plan names, if one does.
template <typename... Cs>
cudaError_t launch_planned(std::tuple<Cs...>*, const Plan& plan,
                           const void* q, const void* k, const void* v,
                           const int* lens, void* out, float* lse, int B,
                           int H, int Sq, int Sk, int D, float scale,
                           int causal, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((D <= Cs::DP && D > Cs::DP - hopper::SUB_COLS &&
          plan.matches(Cs::DP, Cs::ROWS, Cs::BN, Cs::ST, Cs::BYTES) &&
          (err = launch_wgmma<Cs>(q, k, v, lens, out, lse, B, H, Sq, Sk, D,
                                  scale, causal, plan.heavy_first, stream),
           true)) ||
         ...);
  return err;
}

// The body by dtype: bf16 the Hopper body in the build the plan names,
// fp32 the first body.
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lens, void* out, float* lse, int B, int H,
                     int Sq, int Sk, int D, float scale, int causal,
                     int dtype, const Plan& plan, cudaStream_t stream) {
  if (dtype == BF16)
    return launch_planned(static_cast<FwdBuilds*>(nullptr), plan, q, k, v,
                          lens, out, lse, B, H, Sq, Sk, D, scale, causal,
                          stream);
  if (dtype == F32 &&
      plan.matches(D, TILE, TILE, 1, sizeof(float) * 3 * TILE * tile_ld(D)))
    return D <= 64 ? launch<float, 8>(q, k, v, lens, out, lse, B, H, Sq, Sk,
                                      D, scale, causal, stream)
                   : launch<float, 16>(q, k, v, lens, out, lse, B, H, Sq, Sk,
                                       D, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace flash
}  // namespace nezha

// q [B, H, Sq, D], k/v [B, H, Sk, D] of one dtype; lens [B] int32 or null;
// out [B, H, Sq, D] of q's dtype; lse [B, H, Sq] fp32. All contiguous, on
// the current device; causal needs Sq == Sk. plan: the six ints of
// nezha::flash::Plan, in host memory. Returns the launch's cudaError_t.
extern "C" int nezha_flash_fwd(const void* q, const void* k, const void* v,
                               const void* lens, void* out, void* lse, int B,
                               int H, int Sq, int Sk, int D, float scale,
                               int causal, int dtype, void* stream,
                               const void* plan) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > nezha::MAX_D || D % 8 || (causal && Sq != Sk) || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();   // start from a clean error state
  return nezha::flash::dispatch(
      q, k, v, static_cast<const int*>(lens), out, static_cast<float*>(lse),
      B, H, Sq, Sk, D, scale, causal, dtype,
      *static_cast<const nezha::flash::Plan*>(plan),
      static_cast<cudaStream_t>(stream));
}
