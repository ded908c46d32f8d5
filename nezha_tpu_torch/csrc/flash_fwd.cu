// Flash-attention forward for Hopper (sm_90a), the training path.
//
// Replaces: nezha_tpu/ops/pallas/flash_attention.py:_fwd_kernel (built by
// _flash_call), reached from models/gpt2.py Attention (attn_impl "flash",
// which "auto" resolves to) on every layer of every training step.
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
// cores. This first version is simple and right: one block of 4 warps
// per 64 queries, Q.K^T and P.V on the tensor cores (mma.sync), K/V
// tiles staged through shared memory with no overlap of load and math.
// Later work: TMA-fed double buffering and wgmma.
#include "flash_common.cuh"

namespace nezha {
namespace flash {
namespace {

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

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lens, void* out, float* lse, int B, int H,
                     int Sq, int Sk, int D, float scale, int causal,
                     cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 8>(q, k, v, lens, out, lse, B, H, Sq, Sk, D, scale,
                        causal, stream);
  return launch<T, 16>(q, k, v, lens, out, lse, B, H, Sq, Sk, D, scale,
                       causal, stream);
}

}  // namespace
}  // namespace flash
}  // namespace nezha

// q [B, H, Sq, D], k/v [B, H, Sk, D] of one dtype; lens [B] int32 or null;
// out [B, H, Sq, D] of q's dtype; lse [B, H, Sq] fp32. All contiguous, on
// the current device; causal needs Sq == Sk. Returns the launch's
// cudaError_t.
extern "C" int nezha_flash_fwd(const void* q, const void* k, const void* v,
                               const void* lens, void* out, void* lse, int B,
                               int H, int Sq, int Sk, int D, float scale,
                               int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > nezha::MAX_D || D % 8 || (causal && Sq != Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ln = static_cast<const int*>(lens);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (dtype == nezha::BF16)
    return nezha::flash::dispatch<__nv_bfloat16>(q, k, v, ln, out, ls, B, H,
                                                 Sq, Sk, D, scale, causal, s);
  if (dtype == nezha::F32)
    return nezha::flash::dispatch<float>(q, k, v, ln, out, ls, B, H, Sq, Sk,
                                         D, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
