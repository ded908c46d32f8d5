// Flash-attention backward for Hopper (sm_90a), the training path: two
// kernels, as on the TPU.
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
//   dQ = sum_k round(dS) . K     (dq kernel: one block owns 64 queries and
//                                 walks the key tiles),
//   dV = sum_q round(P)^T . dO,  dK = sum_q round(dS)^T . Q
//                                (dkv kernel: one block owns 64 keys and
//                                 walks the query tiles),
// with round() the cast to the inputs' dtype the TPU kernels make before
// each of those dots, and outputs in the inputs' dtype. Every output row
// belongs to one block, which accumulates it in registers: no atomics, so
// the gradients are bitwise repeatable run to run. Keys at or past
// kv_len get exact-zero dK and dV.
//
// What bounds it: at GPT-2's training shape (B=8, H=12, S=1024, D=64,
// causal, bf16) the two kernels do 2.5x the forward's products,
// 4 * 2.5 * B * H * D * S^2 / 2 = 32 GFLOP, against q, k, v, o, dO, dq, dk,
// dv (8 x 12.6 MB) and lse read once: ~320 flop/byte, at the ridge —
// ~33 us on the tensor cores, ~30 us on memory. This first version is
// simple and right: all five products on the tensor cores (mma.sync),
// tiles staged through shared memory with no overlap of load and math,
// and S and dP recomputed in both kernels, as on the TPU.
#include "flash_common.cuh"

namespace nezha {
namespace flash {
namespace {

template <typename T, int ND>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout,
                        const int* __restrict__ lens, T* __restrict__ dq,
                        int H, int Sq, int Sk, int D, float scale,
                        int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float delta_s[TILE];
  const int ld = tile_ld(D);
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + TILE * ld;
  T* ks = dos + TILE * ld;
  T* vs = ks + TILE * ld;

  const int q0 = blockIdx.x * TILE;
  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int g = lane >> 2;
  const int r0 = q0 + warp * ROWS + g;
  const int rows[2] = {r0, r0 + 8};
  const T* kh = k + bh * Sk * D;
  const T* vh = v + bh * Sk * D;

  const int kv_len = key_limit(lens, b, Sk);
  const int k_end = causal ? min(kv_len, q0 + TILE) : kv_len;
  load_tile(qs, q + bh * Sq * D, q0, Sq, D);
  load_tile(dos, dout + bh * Sq * D, q0, Sq, D);
  float row_lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    row_lse[i] = rows[i] < Sq ? lse[bh * Sq + rows[i]] : 0.f;
  __syncthreads();
  tile_delta(delta_s, dos, o + bh * Sq * D, q0, Sq, D);
  __syncthreads();
  const float delta[2] = {delta_s[warp * ROWS + g],
                          delta_s[warp * ROWS + g + 8]};

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
        p[n][e] = pe * (dp[n][e] - delta[i]) * scale;   // dS
      }
    }
    Mma<T>::template rb<ND>(acc, p, ks, D, lane);
  }
  store_rows<T, ND>(dq + bh * Sq * D, acc, r0, Sq, D, lane, 1.f, 1.f);
}

template <typename T, int ND>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
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
  const T* oh = o + bh * Sq * D;
  const float* lh = lse + bh * Sq;

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
      for (int i = threadIdx.x; i < TILE; i += THREADS)
        lse_s[i] = q0 + i < Sq ? lh[q0 + i] : 0.f;
      __syncthreads();
      tile_delta(delta_s, dos, oh, q0, Sq, D);
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

template <typename T, int ND>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const float* lse, const void* dout,
                      const int* lens, void* dq, int B, int H, int Sq, int Sk,
                      int D, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 4 * TILE * tile_ld(D);
  auto kernel = flash_bwd_dq_kernel<T, ND>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o), lse,
      static_cast<const T*>(dout), lens, static_cast<T*>(dq), H, Sq, Sk, D,
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int ND>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       const int* lens, void* dk, void* dv, int B, int H,
                       int Sq, int Sk, int D, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = sizeof(T) * 4 * TILE * tile_ld(D);
  auto kernel = flash_bwd_dkv_kernel<T, ND>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + TILE - 1) / TILE, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o), lse,
      static_cast<const T*>(dout), lens, static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, D, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Sk, int D, int causal) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > MAX_D ||
         D % 8 || (causal && Sq != Sk);
}

}  // namespace
}  // namespace flash
}  // namespace nezha

// q/o/dout [B, H, Sq, D] and k/v [B, H, Sk, D] of one dtype; lse
// [B, H, Sq] fp32 (the forward's); lens [B] int32 or null; dq like q. All
// contiguous, on the current device. Returns the launch's cudaError_t.
extern "C" int nezha_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* lse, const void* dout,
                                  const void* lens, void* dq, int B, int H,
                                  int Sq, int Sk, int D, float scale,
                                  int causal, int dtype, void* stream) {
  using namespace nezha::flash;
  if (bad_shape(B, H, Sq, Sk, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ls = static_cast<const float*>(lse);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (dtype == nezha::BF16)
    return D <= 64 ? launch_dq<__nv_bfloat16, 8>(q, k, v, o, ls, dout, ln,
                                                 dq, B, H, Sq, Sk, D, scale,
                                                 causal, s)
                   : launch_dq<__nv_bfloat16, 16>(q, k, v, o, ls, dout, ln,
                                                  dq, B, H, Sq, Sk, D, scale,
                                                  causal, s);
  if (dtype == nezha::F32)
    return D <= 64 ? launch_dq<float, 8>(q, k, v, o, ls, dout, ln, dq, B, H,
                                         Sq, Sk, D, scale, causal, s)
                   : launch_dq<float, 16>(q, k, v, o, ls, dout, ln, dq, B, H,
                                          Sq, Sk, D, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As nezha_flash_bwd_dq; dk and dv like k and v.
extern "C" int nezha_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   const void* lens, void* dk, void* dv,
                                   int B, int H, int Sq, int Sk, int D,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  using namespace nezha::flash;
  if (bad_shape(B, H, Sq, Sk, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ls = static_cast<const float*>(lse);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // start from a clean error state
  if (dtype == nezha::BF16)
    return D <= 64 ? launch_dkv<__nv_bfloat16, 8>(q, k, v, o, ls, dout, ln,
                                                  dk, dv, B, H, Sq, Sk, D,
                                                  scale, causal, s)
                   : launch_dkv<__nv_bfloat16, 16>(q, k, v, o, ls, dout, ln,
                                                   dk, dv, B, H, Sq, Sk, D,
                                                   scale, causal, s);
  if (dtype == nezha::F32)
    return D <= 64 ? launch_dkv<float, 8>(q, k, v, o, ls, dout, ln, dk, dv,
                                          B, H, Sq, Sk, D, scale, causal, s)
                   : launch_dkv<float, 16>(q, k, v, o, ls, dout, ln, dk, dv,
                                           B, H, Sq, Sk, D, scale, causal,
                                           s);
  return static_cast<int>(cudaErrorInvalidValue);
}
