// Flash-attention backward for Hopper (sm_90a), the training path: two
// kernels, as on the TPU, after a pre-pass.
//
// Replaces: nezha_tpu/ops/pallas/flash_attention.py:_bwd_dq_kernel and
// :_bwd_dkv_kernel (built by _flash_bwd_call), reached through the
// backward of the flash attention autograd function on every layer of
// every training step.
//
// Both recompute P blockwise from (q, k, lse) instead of keeping the
// S x S matrix: p = exp(q.k * scale - lse), masked to exact zero (NEG_BIG
// scores; causal, key j >= kv_len, and rows past the sequence), then
//   dP = dO . V^T,  delta = rowsum(dO * O) (fp32),
//   dS = P * (dP - delta) * scale,
//   dQ = sum_k round(dS) . K     (dq kernel: a block owns 64 NC queries
//                                 and walks the key tiles),
//   dV = sum_q round(P)^T . dO,  dK = sum_q round(dS)^T . Q
//                                (dkv kernel: a block owns 64 NC keys and
//                                 walks the query tiles),
// with round() the cast to the inputs' dtype the TPU kernels make before
// each of those dots, and outputs in the inputs' dtype. Every output row
// belongs to one block, which accumulates it in registers: no atomics, so
// the gradients are bitwise repeatable run to run. Keys at or past
// kv_len get exact-zero dK and dV.
//
// What bounds it: at GPT-2's training shape (B=8, H=12, S=1024, D=64,
// causal, bf16) the two kernels do 2.5x the forward's products,
// 4 * 2.5 * B * H * D * S^2 / 2 = 32 GFLOP, against q, k, v, dO, dq, dk,
// dv (7 x 12.6 MB) and lse, delta read once: ~360 flop/byte, at the ridge
// — ~33 us on the tensor cores, ~27 us on memory.
//
// A pre-pass, flash_bwd_delta_kernel, writes delta [B, H, Sq] once (two
// threads a row, delta_half), which both kernels read instead of
// recomputing it from a fresh read of O. Then each kernel has two bodies,
// chosen by dtype in dispatch_dq() and dispatch_dkv() — not a fallback:
//
// bf16, both warp-specialised on csrc/hopper.cuh: a producer warpgroup,
// of which one thread TMA-loads the rows the block owns once and streams
// the other side's tiles (128-byte swizzle, zero fill past S and D)
// through an ST-stage ring on full/empty mbarriers, and NC consumer
// warpgroups of 64 rows each. The producer gives its registers to the
// consumers (setmaxnreg 24 / 232 at NC = 1, two blocks an SM, or 240 at
// NC = 2). The mask runs only on the tile that crosses the diagonal, the
// end of the queries or kv_len. The geometry is decided in
// ops/cuda/flash_attention.py (DQ_BUILDS, DKV_BUILDS, timed with
// tools/tune_flash_plans.py) and checked here against DqBuilds, DkvBuilds.
//
//   flash_bwd_dq_wgmma_kernel: the block owns Q and dO, and streams K and
//   V tiles of BN keys. Per key tile a consumer runs S = Q.K^T and
//   dP = dO.V^T as wgmma m64nBNk16 (all four operands by descriptor,
//   K-major), forms dS in fp32 registers from its two rows' lse and delta
//   (read straight from device memory: a row's 4 bytes start below TMA's
//   16-byte grain), rounds dS to bf16 as the A fragments of dQ += dS.K
//   (K by descriptor, MN-major). The next tile's S and dP are issued with
//   this tile's dS.K, so forming the next dS overlaps the product. A
//   causal consumer stops at its diagonal key tile, and the grid launches
//   the last query tile, the heaviest, first. dQ stays in fp32 registers
//   until one store.
//
//   flash_bwd_dkv_wgmma_kernel: the block owns K and V, and streams Q and
//   dO tiles of 64 queries (a second producer warp copies their lse and
//   delta slices). Per query tile a consumer runs S^T = K.Q^T and
//   dP^T = V.dO^T (all operands by descriptor), forms P^T and dS^T in
//   fp32, rounds them to bf16 in registers, and runs dV += P^T.dO and
//   dK += dS^T.Q with A from registers and dO, Q by descriptor
//   (transposed). Under causal a key tile starts at the diagonal query
//   tile, and the grid launches key tile 0, the heaviest, first. At
//   D = 128 dK and dV take 128 registers a thread and S^T, dP^T 64 more,
//   so the query tile is 64 wide.
//
// fp32: flash_bwd_dq_kernel and flash_bwd_dkv_kernel, the first versions
// (wgmma has no fp32 operands): 4 warps per 64 rows on the FMA pipes,
// tiles staged through shared memory with no overlap of load and math,
// delta from the pre-pass.
#include "flash_common.cuh"
#include "hopper.cuh"

#include <tuple>

namespace nezha {
namespace flash {
namespace {

// The fp32 dq body (see the note at the top); delta from the pre-pass.
template <typename T, int ND>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ delta,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout,
                        const int* __restrict__ lens, T* __restrict__ dq,
                        int H, int Sq, int Sk, int D, float scale,
                        int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld(D);
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + TILE * ld;
  T* ks = dos + TILE * ld;
  T* vs = ks + TILE * ld;

  const int q0 = blockIdx.x * TILE;
  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int r0 = q0 + warp * ROWS + (lane >> 2);
  const int rows[2] = {r0, r0 + 8};
  const T* kh = k + bh * Sk * D;
  const T* vh = v + bh * Sk * D;

  const int kv_len = key_limit(lens, b, Sk);
  const int k_end = causal ? min(kv_len, q0 + TILE) : kv_len;
  load_tile(qs, q + bh * Sq * D, q0, Sq, D);
  load_tile(dos, dout + bh * Sq * D, q0, Sq, D);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < Sq;
    row_lse[i] = in ? lse[bh * Sq + rows[i]] : 0.f;
    row_delta[i] = in ? delta[bh * Sq + rows[i]] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float p[NT][4], dp[NT][4];

  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();
    load_tile(ks, kh, k0, Sk, D);
    load_tile(vs, vh, k0, Sk, D);
    __syncthreads();
    Mma<T>::abt(p, qs + warp * ROWS * ld, ks, D, lane);
    Mma<T>::abt(dp, dos + warp * ROWS * ld, vs, D, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = frag_row(e);
        const int col = k0 + frag_col(n, e, lane);
        const bool ok = col < kv_len && (!causal || col <= rows[i]);
        const float pe = ok ? expf(p[n][e] * scale - row_lse[i]) : 0.f;
        p[n][e] = pe * (dp[n][e] - row_delta[i]) * scale;   // dS
      }
    }
    Mma<T>::template rb<ND>(acc, p, ks, D, lane);
  }
  store_rows<T, ND>(dq + bh * Sq * D, acc, r0, Sq, D, lane, 1.f, 1.f);
}

// The fp32 dK/dV body (see the note at the top); delta from the pre-pass.
template <typename T, int ND>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ delta,
                         const float* __restrict__ lse,
                         const T* __restrict__ dout,
                         const int* __restrict__ lens, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Sq, int Sk, int D,
                         float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float lse_s[TILE];
  __shared__ float delta_s[TILE];
  const int ld = tile_ld(D);
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + TILE * ld;
  T* qs = vs + TILE * ld;
  T* dos = qs + TILE * ld;

  const int k0 = blockIdx.x * TILE;
  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int g = lane >> 2;
  const int r0 = k0 + warp * ROWS + g;             // this lane's keys r0,
  const int rows[2] = {r0, r0 + 8};                // r0 + 8
  const T* qh = q + bh * Sq * D;
  const T* doh = dout + bh * Sq * D;
  const float* lh = lse + bh * Sq;
  const float* dh = delta + bh * Sq;

  const int kv_len = key_limit(lens, b, Sk);
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }
  // A key tile wholly past kv_len has p = 0 everywhere: exact zeros.
  if (k0 < kv_len) {
    load_tile(ks, k + bh * Sk * D, k0, Sk, D);
    load_tile(vs, v + bh * Sk * D, k0, Sk, D);
    float pt[NT][4], dpt[NT][4];
    // Causal: query tiles wholly above the diagonal see none of these
    // keys; the first that does starts at k0.
    for (int q0 = causal ? k0 : 0; q0 < Sq; q0 += TILE) {
      __syncthreads();
      load_tile(qs, qh, q0, Sq, D);
      load_tile(dos, doh, q0, Sq, D);
      for (int i = threadIdx.x; i < TILE; i += THREADS) {
        lse_s[i] = q0 + i < Sq ? lh[q0 + i] : 0.f;
        delta_s[i] = q0 + i < Sq ? dh[q0 + i] : 0.f;
      }
      __syncthreads();
      Mma<T>::abt(pt, ks + warp * ROWS * ld, qs, D, lane);   // S^T
      Mma<T>::abt(dpt, vs + warp * ROWS * ld, dos, D, lane); // dP^T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = frag_col(n, e, lane);
          const int qc = q0 + c;
          const int key = rows[frag_row(e)];
          const bool ok =
              qc < Sq && key < kv_len && (!causal || key <= qc);
          const float pe = ok ? expf(pt[n][e] * scale - lse_s[c]) : 0.f;
          pt[n][e] = pe;
          dpt[n][e] = pe * (dpt[n][e] - delta_s[c]) * scale;   // dS^T
        }
      }
      Mma<T>::template rb<ND>(dv_acc, pt, dos, D, lane);
      Mma<T>::template rb<ND>(dk_acc, dpt, qs, D, lane);
    }
  }
  store_rows<T, ND>(dk + bh * Sk * D, dk_acc, r0, Sk, D, lane, 1.f, 1.f);
  store_rows<T, ND>(dv + bh * Sk * D, dv_acc, r0, Sk, D, lane, 1.f, 1.f);
}

template <int ND>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const float* delta, const float* lse,
                          const void* dout, const int* lens, void* dq, int B,
                          int H, int Sq, int Sk, int D, float scale,
                          int causal, cudaStream_t stream) {
  using T = float;
  const size_t smem = sizeof(T) * 4 * TILE * tile_ld(D);
  auto kernel = flash_bwd_dq_kernel<T, ND>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), delta, lse, static_cast<const T*>(dout),
      lens, static_cast<T*>(dq), H, Sq, Sk, D, scale, causal);
  return cudaGetLastError();
}

template <int ND>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const float* delta, const float* lse,
                           const void* dout, const int* lens, void* dk,
                           void* dv, int B, int H, int Sq, int Sk, int D,
                           float scale, int causal, cudaStream_t stream) {
  using T = float;
  const size_t smem = sizeof(T) * 4 * TILE * tile_ld(D);
  auto kernel = flash_bwd_dkv_kernel<T, ND>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + TILE - 1) / TILE, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), delta, lse, static_cast<const T*>(dout),
      lens, static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, D, scale,
      causal);
  return cudaGetLastError();
}

// ------------------------------------------------ the delta pre-pass
// delta = rowsum(dO * O) in fp32 for every row of [B * H * Sq], once, for
// the dq and dK/dV kernels to read: two threads a row (delta_half).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_delta_kernel(const T* __restrict__ o,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, int n_rows, int D) {
  const int row = blockIdx.x * TILE + (threadIdx.x >> 1);
  const int half = threadIdx.x & 1;
  float sum = 0.f;
  if (row < n_rows)
    sum = delta_half(dout + static_cast<size_t>(row) * D,
                     o + static_cast<size_t>(row) * D, D, half);
  sum += __shfl_xor_sync(FULL, sum, 1);
  if (half == 0 && row < n_rows) delta[row] = sum;
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int n_rows, int D, cudaStream_t stream) {
  flash_bwd_delta_kernel<T><<<(n_rows + TILE - 1) / TILE, THREADS, 0,
                              stream>>>(static_cast<const T*>(o),
                                        static_cast<const T*>(dout), delta,
                                        n_rows, D);
  return cudaGetLastError();
}

// --------------------------------------------- bf16 dK/dV: wgmma and TMA
// One build of the bf16 dK/dV body: DP the padded head dim, NC consumer
// warpgroups of 64 keys (a block owns 64 NC keys), ST query tiles of 64
// rows in flight. A block is a producer warpgroup plus the consumers;
// one block an SM at NC = 2, two at NC = 1. A thread starts with 168
// registers (NC = 2) or 128 (NC = 1); setmaxnreg drops the producer's to
// 24 and raises the consumers' to 240 or 232.
//
// Shared memory, in bytes from the 1024-aligned base: K, V (DP / 64
// sub-tiles of ROWS lines each), per stage a Q and a dO tile (sub-tiles
// of QROWS lines), per stage an lse and a delta slice (QROWS fp32 each),
// then the barriers kv_full, full[stage], empty[stage]. BYTES adds 1024
// for the alignment. FlashPlan (ops/cuda/flash_attention.py) computes the
// same.
template <int DP_, int NC_, int ST_>
struct Dkv {
  static constexpr int DP = DP_, NC = NC_, ST = ST_;
  static constexpr int ROWS = 64 * NC;
  static constexpr int QROWS = 64;
  static constexpr int THREADS = (1 + NC) * hopper::WG_THREADS;
  static constexpr int BLOCKS_PER_SM = NC == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = NC == 1 ? 232 : 240;
  static constexpr int KV_BYTES = ROWS * DP * 2;
  static constexpr int Q_BYTES = QROWS * DP * 2;
  static constexpr int VEC_BYTES = QROWS * 4;
  static constexpr int V = KV_BYTES;
  static constexpr int RING = 2 * KV_BYTES;   // stage s: Q, then dO
  static constexpr int VECS = RING + ST * 2 * Q_BYTES;
  static constexpr int BAR = VECS + ST * 2 * VEC_BYTES;
  static constexpr int BYTES = 1024 + BAR + 8 * (1 + 2 * ST);
};

// The builds the entry point can launch, one a padded D (DKV_BUILDS in
// ops/cuda/flash_attention.py); the plan picks one.
using DkvBuilds = std::tuple<Dkv<64, 1, 2>, Dkv<128, 1, 2>>;

template <typename C>
__global__ void __launch_bounds__(C::THREADS, C::BLOCKS_PER_SM)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const int* __restrict__ lens,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int H, int Sq,
                               int Sk, int D, float scale, float scale_log2,
                               int causal) {
  using namespace hopper;
  constexpr int DP = C::DP, BK_ROWS = C::ROWS, BK_QROWS = C::QROWS;
  constexpr int BK_STAGES = C::ST;
  constexpr int SUB = DP / SUB_COLS;     // 64-column sub-tiles
  constexpr int NS = BK_QROWS / 8;       // 8-column groups of S^T, dP^T
  constexpr int NO = DP / 8;             // of dK, dV
  constexpr int KS = BK_QROWS / 16;      // 16-query steps of P^T . dO
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + BK_STAGES;

  // Under causal, key tile 0 meets the most query tiles, so ascending
  // ranks launch the heaviest first.
  const int k0 = blockIdx.y * BK_ROWS;
  const int bh = blockIdx.x;
  const int kv_len = key_limit(lens, bh / H, Sk);
  // Causal: query tiles wholly above the diagonal see none of these keys;
  // the first that does starts at k0. A block wholly past kv_len has
  // p = 0 everywhere: it loads nothing and writes exact zeros.
  const int q_begin = causal ? k0 : 0;
  const int n_q =
      k0 < kv_len ? (Sq - q_begin + BK_QROWS - 1) / BK_QROWS : 0;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < BK_STAGES; ++s) {
      mbar_init(full + s, 1 + WARP);            // the TMA thread, the slice warp
      mbar_init(empty + s, C::NC * 4);   // each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {   // the producer: one thread issues every load
    regs_release<24>();
    const int pw = threadIdx.x / WARP;
    if (threadIdx.x == 0 && n_q > 0) {   // K, V, then the Q and dO ring
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int c = 0; c < SUB; ++c) {
        tma_load_3d(sm + c * BK_ROWS * LINE, &tk, kv_full, c * SUB_COLS, k0,
                    bh);
        tma_load_3d(sm + C::V + c * BK_ROWS * LINE, &tv, kv_full,
                    c * SUB_COLS, k0, bh);
      }
      for (int i = 0; i < n_q; ++i) {
        const int s = i % BK_STAGES;
        const int q0 = q_begin + i * BK_QROWS;
        mbar_wait(empty + s, ((i / BK_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * C::Q_BYTES);
        unsigned char* qt = sm + C::RING + s * 2 * C::Q_BYTES;
        for (int c = 0; c < SUB; ++c) {
          tma_load_3d(qt + c * BK_QROWS * LINE, &tq, full + s, c * SUB_COLS,
                      q0, bh);
          tma_load_3d(qt + C::Q_BYTES + c * BK_QROWS * LINE, &tdo, full + s,
                      c * SUB_COLS, q0, bh);
        }
      }
    } else if (pw == 1 && n_q > 0) {
      // The lse and delta slices: a row's 4 bytes start anywhere, below
      // TMA's 16-byte grain, so one warp copies them and arrives (the
      // arrival releases its stores to the consumers).
      const int lane = threadIdx.x % WARP;
      const float* lh = lse + static_cast<size_t>(bh) * Sq;
      const float* dh = delta + static_cast<size_t>(bh) * Sq;
      for (int i = 0; i < n_q; ++i) {
        const int s = i % BK_STAGES;
        const int q0 = q_begin + i * BK_QROWS;
        mbar_wait(empty + s, ((i / BK_STAGES) & 1) ^ 1);
        float* vt = reinterpret_cast<float*>(sm + C::VECS +
                                             s * 2 * C::VEC_BYTES);
        for (int r = lane; r < BK_QROWS; r += WARP) {
          const bool in = q0 + r < Sq;
          vt[r] = in ? lh[q0 + r] : 0.f;
          vt[BK_QROWS + r] = in ? dh[q0 + r] : 0.f;
        }
        mbar_arrive(full + s);
      }
    }
    return;
  }
  regs_claim<C::CONSUMER_REGS>();

  // A consumer: 64 keys from kw; this lane's keys r0 and r0 + 8.
  const int cw = wg - 1;
  const int t = threadIdx.x % WG_THREADS;
  const int warp = t / WARP, lane = t % WARP;
  const int kw = k0 + 64 * cw;
  const int r0 = kw + 16 * warp + (lane >> 2);
  const int keys[2] = {r0, r0 + 8};
  const bool live = kw < kv_len;
  const uint32_t k_base = smem_addr(sm) + 64 * cw * LINE;
  const uint32_t v_base = smem_addr(sm + C::V) + 64 * cw * LINE;

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }
  float st[NS][4], dpt[NS][4];
  uint32_t pa[KS][4], da[KS][4];

  if (n_q > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_q; ++i) {
    const int s = i % BK_STAGES;
    const int q0 = q_begin + i * BK_QROWS;
    mbar_wait(full + s, (i / BK_STAGES) & 1);
    if (live && (!causal || q0 + BK_QROWS - 1 >= kw)) {
      const uint32_t q_base = smem_addr(sm + C::RING + s * 2 * C::Q_BYTES);
      const uint32_t do_base = q_base + C::Q_BYTES;
      const float* lse_s =
          reinterpret_cast<const float*>(sm + C::VECS + s * 2 * C::VEC_BYTES);
      const float* delta_s = lse_s + BK_QROWS;

      // S^T = K . Q^T and dP^T = V . dO^T: 16 columns of D a step, all
      // four operands K-major.
      fence_acc(st);
      fence_acc(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        mma_ss<BK_QROWS, 0>(
            st, sw128_desc(k_base + (kk / 4) * BK_ROWS * LINE + col, 16, 1024),
            sw128_desc(q_base + (kk / 4) * BK_QROWS * LINE + col, 16, 1024),
            kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        mma_ss<BK_QROWS, 0>(
            dpt,
            sw128_desc(v_base + (kk / 4) * BK_ROWS * LINE + col, 16, 1024),
            sw128_desc(do_base + (kk / 4) * BK_QROWS * LINE + col, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);

      // P^T and dS^T in fp32; the mask only on the tile that crosses the
      // diagonal, the end of the queries or kv_len.
      const bool edge = (causal && q0 < kw + 63) || q0 + BK_QROWS > Sq ||
                        kw + 64 > kv_len;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = frag_col(n, e, lane);
          const int key = keys[frag_row(e)];
          const bool ok = !edge || (q0 + c < Sq && key < kv_len &&
                                    (!causal || key <= q0 + c));
          const float pe =
              ok ? exp2_approx(fmaf(st[n][e], scale_log2, -lse_s[c] * LOG2E))
                 : 0.f;
          st[n][e] = pe;
          dpt[n][e] = pe * (dpt[n][e] - delta_s[c]) * scale;
        }
      }
      // Rounded to bf16, packed as the A fragments of the next products.
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        pa[kk][0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        pa[kk][1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        pa[kk][2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        da[kk][0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        da[kk][1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        da[kk][2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        da[kk][3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
      }

      // dV += P^T . dO and dK += dS^T . Q: 16 queries a step, dO and Q
      // MN-major (transposed).
      fence_acc(dv_acc);
      fence_acc(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_rs<DP, 1>(
            dv_acc, pa[kk],
            sw128_desc(do_base + kk * 16 * LINE, BK_QROWS * LINE, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_rs<DP, 1>(
            dk_acc, da[kk],
            sw128_desc(q_base + kk * 16 * LINE, BK_QROWS * LINE, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv_acc);
      fence_acc(dk_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);   // this warp is done with it
  }

  const size_t row0 = static_cast<size_t>(bh) * Sk * D;
  store_rows_bf16x2<NO>(dk + row0, dk_acc, r0, Sk, D, lane, 1.f, 1.f);
  store_rows_bf16x2<NO>(dv + row0, dv_acc, r0, Sk, D, lane, 1.f, 1.f);
}

template <typename C>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const float* delta, const float* lse,
                             const void* dout, const int* lens, void* dk,
                             void* dv, int B, int H, int Sq, int Sk, int D,
                             float scale, int causal, cudaStream_t stream) {
  const int bh = B * H;
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::map_bf16_3d(&tq, q, D, Sq, bh, C::QROWS) ||
      !hopper::map_bf16_3d(&tdo, dout, D, Sq, bh, C::QROWS) ||
      !hopper::map_bf16_3d(&tk, k, D, Sk, bh, C::ROWS) ||
      !hopper::map_bf16_3d(&tv, v, D, Sk, bh, C::ROWS))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_wgmma_kernel<C>;
  cudaError_t err = prepare(kernel, C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (Sk + C::ROWS - 1) / C::ROWS);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(
      tq, tk, tv, tdo, lse, delta, lens, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Sk, D, scale, scale * LOG2E,
      causal);
  return cudaGetLastError();
}

// Launch the build of the bf16 body that the plan names, if one does (its
// order is heaviest first only).
template <typename... Cs>
cudaError_t launch_planned_dkv(std::tuple<Cs...>*, const Plan& plan,
                               const void* q, const void* k, const void* v,
                               const float* delta, const float* lse,
                               const void* dout, const int* lens, void* dk,
                               void* dv, int B, int H, int Sq, int Sk, int D,
                               float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((D <= Cs::DP && D > Cs::DP - hopper::SUB_COLS &&
          plan.heavy_first == 1 &&
          plan.matches(Cs::DP, Cs::ROWS, Cs::QROWS, Cs::ST, Cs::BYTES) &&
          (err = launch_dkv_wgmma<Cs>(q, k, v, delta, lse, dout, lens, dk,
                                      dv, B, H, Sq, Sk, D, scale, causal,
                                      stream),
           true)) ||
         ...);
  return err;
}

// The dK/dV body by dtype: bf16 the Hopper body in the build the plan
// names, fp32 the first body.
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const float* delta, const float* lse,
                         const void* dout, const int* lens, void* dk,
                         void* dv, int B, int H, int Sq, int Sk, int D,
                         float scale, int causal, int dtype, const Plan& plan,
                         cudaStream_t stream) {
  if (dtype == BF16)
    return launch_planned_dkv(static_cast<DkvBuilds*>(nullptr), plan, q, k,
                              v, delta, lse, dout, lens, dk, dv, B, H, Sq,
                              Sk, D, scale, causal, stream);
  if (dtype == F32 &&
      plan.matches(D, TILE, TILE, 1, sizeof(float) * 4 * TILE * tile_ld(D)))
    return D <= 64 ? launch_dkv_f32<8>(q, k, v, delta, lse, dout, lens, dk,
                                       dv, B, H, Sq, Sk, D, scale, causal,
                                       stream)
                   : launch_dkv_f32<16>(q, k, v, delta, lse, dout, lens, dk,
                                        dv, B, H, Sq, Sk, D, scale, causal,
                                        stream);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------ bf16 dQ: wgmma and TMA
// One build of the bf16 dQ body: DP the padded head dim, NC consumer
// warpgroups of 64 queries (a block owns 64 NC queries), BN keys a
// streamed K/V tile holds, ST tiles in flight. A block is a producer
// warpgroup plus the consumers; one block an SM at NC = 2, two at NC = 1.
// A thread starts with 168 registers (NC = 2) or 128 (NC = 1); setmaxnreg
// drops the producer's to 24 and raises the consumers' to 240 or 232.
//
// Shared memory, in bytes from the 1024-aligned base: Q, then dO (DP / 64
// sub-tiles of ROWS lines each), per stage a K and a V tile (sub-tiles of
// BN lines), then the barriers qdo_full, full[stage], empty[stage]. BYTES
// adds 1024 for the alignment. FlashPlan (ops/cuda/flash_attention.py)
// computes the same.
template <int DP_, int NC_, int BN_, int ST_>
struct Dq {
  static constexpr int DP = DP_, NC = NC_, BN = BN_, ST = ST_;
  static constexpr int ROWS = 64 * NC;
  static constexpr int THREADS = (1 + NC) * hopper::WG_THREADS;
  static constexpr int BLOCKS_PER_SM = NC == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = NC == 1 ? 232 : 240;
  static constexpr int Q_BYTES = ROWS * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;
  static constexpr int DO = Q_BYTES;
  static constexpr int RING = 2 * Q_BYTES;   // stage s: K, then V
  static constexpr int BAR = RING + ST * 2 * KV_BYTES;
  static constexpr int BYTES = 1024 + BAR + 8 * (1 + 2 * ST);
};

// The builds the entry point can launch, one a padded D (DQ_BUILDS in
// ops/cuda/flash_attention.py); the plan picks one.
using DqBuilds = std::tuple<Dq<64, 1, 64, 3>, Dq<128, 1, 64, 2>>;

template <typename C>
__global__ void __launch_bounds__(C::THREADS, C::BLOCKS_PER_SM)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ lens,
                              __nv_bfloat16* __restrict__ dq, int H, int Sq,
                              int Sk, int D, float scale, float scale_log2,
                              int causal, int heavy_first) {
  using namespace hopper;
  constexpr int DP = C::DP, DQ_ROWS = C::ROWS, DQ_KEYS = C::BN;
  constexpr int DQ_STAGES = C::ST;
  constexpr int SUB = DP / SUB_COLS;     // 64-column sub-tiles
  constexpr int NS = DQ_KEYS / 8;        // 8-column groups of S, dP
  constexpr int NO = DP / 8;             // of dQ
  constexpr int KS = DQ_KEYS / 16;       // 16-key steps of dS . K
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + DQ_STAGES;

  // Under causal, query tile n_qt - 1 meets the most key tiles: rank 0.
  const int n_qt = (Sq + DQ_ROWS - 1) / DQ_ROWS;
  const int rank = blockIdx.y;
  const int q0 = (causal && heavy_first ? n_qt - 1 - rank : rank) * DQ_ROWS;
  const int bh = blockIdx.x;
  const int kv_len = key_limit(lens, bh / H, Sk);
  const int k_end = causal ? min(kv_len, q0 + DQ_ROWS) : kv_len;
  const int n_kt = (k_end + DQ_KEYS - 1) / DQ_KEYS;   // >= 1: kv_len >= 1
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, C::NC * 4);   // each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {   // the producer: one thread issues every load
    regs_release<24>();
    if (threadIdx.x == 0) {   // Q and dO, then the K and V ring
      mbar_expect_tx(qdo_full, 2 * C::Q_BYTES);
      for (int c = 0; c < SUB; ++c) {
        tma_load_3d(sm + c * DQ_ROWS * LINE, &tq, qdo_full, c * SUB_COLS,
                    q0, bh);
        tma_load_3d(sm + C::DO + c * DQ_ROWS * LINE, &tdo, qdo_full,
                    c * SUB_COLS, q0, bh);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % DQ_STAGES;
        mbar_wait(empty + s, ((j / DQ_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * C::KV_BYTES);
        unsigned char* kt = sm + C::RING + s * 2 * C::KV_BYTES;
        for (int c = 0; c < SUB; ++c) {
          tma_load_3d(kt + c * DQ_KEYS * LINE, &tk, full + s, c * SUB_COLS,
                      j * DQ_KEYS, bh);
          tma_load_3d(kt + C::KV_BYTES + c * DQ_KEYS * LINE, &tv, full + s,
                      c * SUB_COLS, j * DQ_KEYS, bh);
        }
      }
    }
    return;
  }
  regs_claim<C::CONSUMER_REGS>();

  // A consumer: 64 queries from qw; this lane's rows r0 and r0 + 8.
  const int cw = wg - 1;
  const int t = threadIdx.x % WG_THREADS;
  const int warp = t / WARP, lane = t % WARP;
  const int qw = q0 + 64 * cw;
  const int r0 = qw + 16 * warp + (lane >> 2);
  const int rows[2] = {r0, r0 + 8};
  const uint32_t q_base = smem_addr(sm) + 64 * cw * LINE;
  const uint32_t do_base = smem_addr(sm + C::DO) + 64 * cw * LINE;
  // The key tiles this consumer folds: under causal those up to its own
  // diagonal (the block's last tiles may hold keys only its later
  // consumer sees); none past the queries.
  const int n_mine = qw >= Sq ? 0
                     : causal ? min(n_kt, (qw + 63) / DQ_KEYS + 1)
                              : n_kt;
  // Each row's lse (negated, base 2) and delta, read straight from device
  // memory: a row's 4 bytes start at any 4-byte offset.
  float neg_lse2[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < Sq;
    const size_t at = static_cast<size_t>(bh) * Sq + rows[i];
    neg_lse2[i] = in ? -lse[at] * LOG2E : 0.f;
    row_delta[i] = in ? delta[at] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float s[NS][4], dp[NS][4];
  uint32_t da[KS][4];

  // S = Q . K^T and dP = dO . V^T of key tile j: 16 columns of D a step,
  // all four operands K-major. Issued, not waited for.
  auto issue = [&](int j) {
    const int st = j % DQ_STAGES;
    mbar_wait(full + st, (j / DQ_STAGES) & 1);
    const uint32_t k_base = smem_addr(sm + C::RING + st * 2 * C::KV_BYTES);
    const uint32_t v_base = k_base + C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      mma_ss<DQ_KEYS, 0>(
          s, sw128_desc(q_base + (kk / 4) * DQ_ROWS * LINE + col, 16, 1024),
          sw128_desc(k_base + (kk / 4) * DQ_KEYS * LINE + col, 16, 1024),
          kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      mma_ss<DQ_KEYS, 0>(
          dp, sw128_desc(do_base + (kk / 4) * DQ_ROWS * LINE + col, 16, 1024),
          sw128_desc(v_base + (kk / 4) * DQ_KEYS * LINE + col, 16, 1024),
          kk > 0);
    }
    wgmma_commit();
  };
  // dS of key tile j in fp32, in place of its scores; the mask only on
  // the tile that crosses the diagonal, the end of the queries or kv_len.
  auto form = [&](int j) {
    const int k0 = j * DQ_KEYS;
    const bool edge = (causal && k0 + DQ_KEYS - 1 > qw) ||
                      k0 + DQ_KEYS > kv_len || qw + 64 > Sq;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = frag_row(e);
        const int key = k0 + frag_col(n, e, lane);
        const bool ok =
            !edge || (key < kv_len && (!causal || key <= rows[i]));
        const float pe =
            ok ? exp2_approx(fmaf(s[n][e], scale_log2, neg_lse2[i])) : 0.f;
        s[n][e] = pe * (dp[n][e] - row_delta[i]) * scale;
      }
    }
  };
  // dS rounded to bf16 (ds.astype(k.dtype)), packed as the A fragments of
  // dS . K.
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      da[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      da[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      da[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      da[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  };

  mbar_wait(qdo_full, 0);
  if (n_mine > 0) {
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
    issue(0);
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    form(0);
    pack();
  }
  // Per key tile j: issue S, dP of tile j + 1 and dQ += dS_j . K_j; form
  // dS of tile j + 1 while dS_j . K_j runs; then pack it.
  for (int j = 0; j < n_mine; ++j) {
    const int st = j % DQ_STAGES;
    const bool more = j + 1 < n_mine;
    const uint32_t k_base = smem_addr(sm + C::RING + st * 2 * C::KV_BYTES);
    fence_acc(s);
    fence_acc(dp);
    fence_acc(acc);
    wgmma_fence();
    if (more) issue(j + 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)   // K MN-major (transposed)
      mma_rs<DP, 1>(acc, da[kk],
                    sw128_desc(k_base + kk * 16 * LINE, DQ_KEYS * LINE, 1024),
                    1);
    wgmma_commit();
    if (more) {
      wgmma_wait<1>();   // S and dP of tile j + 1
      fence_acc(s);
      fence_acc(dp);
      form(j + 1);
    }
    wgmma_wait<0>();     // dS_j . K_j
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);   // this warp is done with it
    if (more) pack();
  }
  // The block's tiles past this consumer's diagonal: released unread.
  for (int j = n_mine; j < n_kt; ++j) {
    const int st = j % DQ_STAGES;
    mbar_wait(full + st, (j / DQ_STAGES) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  store_rows_bf16x2<NO>(dq + static_cast<size_t>(bh) * Sq * D, acc, r0, Sq,
                        D, lane, 1.f, 1.f);
}

template <typename C>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const float* delta, const float* lse,
                            const void* dout, const int* lens, void* dq,
                            int B, int H, int Sq, int Sk, int D, float scale,
                            int causal, int heavy_first,
                            cudaStream_t stream) {
  const int bh = B * H;
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::map_bf16_3d(&tq, q, D, Sq, bh, C::ROWS) ||
      !hopper::map_bf16_3d(&tdo, dout, D, Sq, bh, C::ROWS) ||
      !hopper::map_bf16_3d(&tk, k, D, Sk, bh, C::BN) ||
      !hopper::map_bf16_3d(&tv, v, D, Sk, bh, C::BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_wgmma_kernel<C>;
  cudaError_t err = prepare(kernel, C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (Sq + C::ROWS - 1) / C::ROWS);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(
      tq, tk, tv, tdo, lse, delta, lens, static_cast<__nv_bfloat16*>(dq), H,
      Sq, Sk, D, scale, scale * LOG2E, causal, heavy_first);
  return cudaGetLastError();
}

// Launch the build of the bf16 dQ body that the plan names, if one does.
template <typename... Cs>
cudaError_t launch_planned_dq(std::tuple<Cs...>*, const Plan& plan,
                              const void* q, const void* k, const void* v,
                              const float* delta, const float* lse,
                              const void* dout, const int* lens, void* dq,
                              int B, int H, int Sq, int Sk, int D,
                              float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((D <= Cs::DP && D > Cs::DP - hopper::SUB_COLS &&
          plan.matches(Cs::DP, Cs::ROWS, Cs::BN, Cs::ST, Cs::BYTES) &&
          (err = launch_dq_wgmma<Cs>(q, k, v, delta, lse, dout, lens, dq, B,
                                     H, Sq, Sk, D, scale, causal,
                                     plan.heavy_first, stream),
           true)) ||
         ...);
  return err;
}

// The dq body by dtype: bf16 the Hopper body in the build the plan names,
// fp32 the first body.
cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const float* delta, const float* lse,
                        const void* dout, const int* lens, void* dq, int B,
                        int H, int Sq, int Sk, int D, float scale, int causal,
                        int dtype, const Plan& plan, cudaStream_t stream) {
  if (dtype == BF16)
    return launch_planned_dq(static_cast<DqBuilds*>(nullptr), plan, q, k, v,
                             delta, lse, dout, lens, dq, B, H, Sq, Sk, D,
                             scale, causal, stream);
  if (dtype == F32 &&
      plan.matches(D, TILE, TILE, 1, sizeof(float) * 4 * TILE * tile_ld(D)))
    return D <= 64 ? launch_dq_f32<8>(q, k, v, delta, lse, dout, lens, dq, B,
                                      H, Sq, Sk, D, scale, causal, stream)
                   : launch_dq_f32<16>(q, k, v, delta, lse, dout, lens, dq,
                                       B, H, Sq, Sk, D, scale, causal,
                                       stream);
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int H, int Sq, int Sk, int D, int causal) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > MAX_D ||
         D % 8 || (causal && Sq != Sk);
}

}  // namespace
}  // namespace flash
}  // namespace nezha

// q/dout [B, H, Sq, D] and k/v [B, H, Sk, D] of one dtype; lse [B, H, Sq]
// fp32 (the forward's); lens [B] int32 or null; dq like q; delta [B, H,
// Sq] fp32 from nezha_flash_bwd_delta (O itself is read there, not here);
// plan: the six ints of nezha::flash::Plan, in host memory. All
// contiguous, on the current device. Returns the launch's cudaError_t.
extern "C" int nezha_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* lse,
                                  const void* dout, const void* lens,
                                  void* dq, int B, int H, int Sq, int Sk,
                                  int D, float scale, int causal, int dtype,
                                  void* stream, const void* delta,
                                  const void* plan) {
  using namespace nezha::flash;
  if (bad_shape(B, H, Sq, Sk, D, causal) || delta == nullptr ||
      plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();   // start from a clean error state
  return dispatch_dq(q, k, v, static_cast<const float*>(delta),
                     static_cast<const float*>(lse), dout,
                     static_cast<const int*>(lens), dq, B, H, Sq, Sk, D,
                     scale, causal, dtype, *static_cast<const Plan*>(plan),
                     static_cast<cudaStream_t>(stream));
}

// As nezha_flash_bwd_dq; dk and dv like k and v.
extern "C" int nezha_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* lse,
                                   const void* dout, const void* lens,
                                   void* dk, void* dv, int B, int H, int Sq,
                                   int Sk, int D, float scale, int causal,
                                   int dtype, void* stream,
                                   const void* delta, const void* plan) {
  using namespace nezha::flash;
  if (bad_shape(B, H, Sq, Sk, D, causal) || delta == nullptr ||
      plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();   // start from a clean error state
  return dispatch_dkv(q, k, v, static_cast<const float*>(delta),
                      static_cast<const float*>(lse), dout,
                      static_cast<const int*>(lens), dk, dv, B, H, Sq, Sk, D,
                      scale, causal, dtype, *static_cast<const Plan*>(plan),
                      static_cast<cudaStream_t>(stream));
}

// o and dout [B, H, Sq, D] of one dtype -> delta [B, H, Sq] fp32 =
// rowsum(dout * o). All contiguous, on the current device. Returns the
// launch's cudaError_t.
extern "C" int nezha_flash_bwd_delta(const void* o, const void* dout,
                                     void* delta, int B, int H, int Sq,
                                     int D, int dtype, void* stream) {
  using namespace nezha::flash;
  if (bad_shape(B, H, Sq, Sq, D, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  float* d = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rows = B * H * Sq;
  cudaGetLastError();   // start from a clean error state
  if (dtype == nezha::BF16)
    return launch_delta<__nv_bfloat16>(o, dout, d, n_rows, D, s);
  if (dtype == nezha::F32) return launch_delta<float>(o, dout, d, n_rows, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
