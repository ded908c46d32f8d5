// The paged-prefill fold on the tensor cores: the one body of the float
// paged prefill kernel (paged_prefill.cu: _prefill_kernel and, launched
// with q offsets, _prefill_qoff_kernel) and of the int8 prefill kernel's
// attention grid (quant_prefill.cu: _quant_prefill_kernel). The kernels
// differ only in how a tile of prefix keys is staged (through the block
// table from a float pool, or dequantized from an int8 one), how the
// chunk's fresh keys are rounded, and where query i sits in the chunk.
//
// Keys arrive in 64-key tiles: first the cached prefix [0, start) in
// order, then the chunk's own keys [0, S_kc) up to the block's last causal
// diagonal. A warp owns 16 query rows in the accumulator layout of
// mma.m16n8k16 (flash_common.cuh) and folds one tile with its products:
// S = Q.K^T (Mma<T>::abt), then acc += round_T(P).V (Mma<T>::rb). For
// bf16 they run on the tensor cores with fp32 accumulation; for fp32 on
// the FMA pipes in the same layout, so the fp32 instantiations share this
// body.
//
// One warp folds a tile in a few microseconds, a latency its own
// dependent products and exponentials set, so a block that walked the
// tiles one by one would take that latency times the row's ~16 tiles. A
// block of PF_WARPS warps therefore splits each phase's tiles KS ways
// (Plan): it stages KS consecutive tiles at once, and warp (split s, row
// group r) folds tile s of them into its own running state for the 16
// rows of group r, so split s folds tiles s, s + KS, ... of each phase.
// At the end the KS states of each row are merged in split order:
// m = max_s m_s, l = sum_s l_s exp(m_s - m), acc likewise, out = acc /
// max(l, 1e-30). The block owns QT = 16 * PF_WARPS / KS query rows.
//
// Semantics kept from the Pallas kernels (ops/pallas/common.py): masked
// scores are NEG_BIG = -1e30; m, l and acc are fp32; a row that sees no
// key writes exact zeros. The dot dtype of each phase is the caller's: TP
// for the prefix (q and p rounded to it), TQ for the chunk.
//
// A split folds the same tiles, in the same order, whichever block, warp
// or lane holds the row: the tiles a split takes depend on the key
// positions alone. A tile wholly past a row's diagonal leaves its state
// bitwise unchanged (m_new = m, corr = expf(0) = 1, every p =
// expf(NEG_BIG - m) = 0, so l + 0 and acc * 1 + 0.V), and a split that
// saw no key merges as nothing (its weight expf(NEG_BIG - m) is 0): so a
// query gives the same bits in the q-offset form as in the full chunk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace nezha {
namespace prefill {

using flash::Mma;
using flash::NT;
using flash::tile_ld;

constexpr int PF_WARPS = 8;               // warps a block
constexpr int THREADS = PF_WARPS * WARP;
constexpr int KEY_SPLITS = 4;             // KS where the tiles fit (Plan)
constexpr int ROWS = flash::ROWS;         // 16 query rows a warp
constexpr int KEYS = flash::TILE;         // 64 keys a tile
constexpr int MAX_LOADS = 8;   // 16-byte loads a thread stages a tensor
constexpr int MAX_TILE_BYTES = 200 * 1024;
static_assert(KEYS == 8 * NT, "a score tile is 8 column groups of 8");

__host__ __device__ constexpr int larger(int a, int b) {
  return a > b ? a : b;
}

// KS tiles of K and V, KS * 64 rows of D <= 8 * nd values each, fit a
// block: a thread stages at most MAX_LOADS 16-byte loads of the widest
// stored element (src bytes) per tensor, all in flight at once in its
// registers, and the tiles of the widest dot element (wide bytes) take at
// most MAX_TILE_BYTES of shared memory.
__host__ __device__ constexpr bool splits_fit(int ks, int nd, int src,
                                              int wide) {
  return ks * KEYS * 8 * nd * src / 16 <= MAX_LOADS * THREADS &&
         2 * ks * KEYS * (8 * nd + flash::PAD) * wide <= MAX_TILE_BYTES;
}

__host__ __device__ constexpr int pick_splits(int nd, int src, int wide) {
  int ks = KEY_SPLITS;
  while (ks > 1 && !splits_fit(ks, nd, src, wide)) ks /= 2;
  return ks;
}

// The block's shape for query dtype TQ, prefix dot dtype TP, prefix
// stored element SP (the pool's: TP, or int8) and ND accumulator groups.
template <typename TQ, typename TP, typename SP, int ND>
struct Plan {
  static constexpr int WIDE = larger(sizeof(TQ), sizeof(TP));
  static constexpr int KS =
      pick_splits(ND, larger(sizeof(SP), sizeof(TQ)), WIDE);
  static constexpr int QT = PF_WARPS / KS * ROWS;   // query rows a block
  static_assert(PF_WARPS % KS == 0, "whole row groups");

  // Dynamic shared memory: q in TP, q in TQ where the two differ, then
  // the KS K and V tiles, which the merge of the splits' states reuses.
  static __host__ __device__ size_t smem_bytes(int D) {
    const size_t ld = static_cast<size_t>(tile_ld(D));
    const size_t q = QT * ld * sizeof(TP) +
                     (std::is_same<TQ, TP>::value ? 0 : QT * ld * sizeof(TQ));
    const size_t tiles = 2 * KS * KEYS * ld * WIDE;
    const size_t merge =
        static_cast<size_t>(KS) * QT * (D + 2) * sizeof(float);
    return q + (tiles > merge ? tiles : merge);
  }
};

// The element conversions a staged tile applies: Copy keeps the stored
// bits; Rounded<TS, T> rounds through TS to T; Dequant<T> is int8 times
// its row's scale in fp32, rounded to T (kv_quant.cuh dequant).
struct Copy {};
template <typename TS, typename T>
struct Rounded {
  __device__ __forceinline__ T operator()(float x, float) const {
    return from_float<T>(round_to<TS>(x));
  }
};
template <typename T>
struct Dequant {
  __device__ __forceinline__ T operator()(float x, float s) const {
    return from_float<T>(__fmul_rn(x, s));
  }
};

__device__ __forceinline__ float load_float(float x) { return x; }
__device__ __forceinline__ float load_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float load_float(int8_t x) {
  return static_cast<float>(x);
}

struct NoScale {
  __device__ __forceinline__ float operator()(int) const { return 1.f; }
};

// Zero the pad columns of an NROWS-row tile when D is 8 mod 16: the last
// 16-deep mma step reads them.
template <typename Dst, int NROWS>
__device__ __forceinline__ void zero_pad(Dst* __restrict__ t, int D) {
  if (D & 15) {
    for (int i = threadIdx.x; i < NROWS * flash::PAD; i += THREADS)
      t[(i / flash::PAD) * tile_ld(D) + D + i % flash::PAD] =
          from_float<Dst>(0.f);
  }
}

// Stage rows [0, n) of the q tile, NROWS rows of Dst (row stride
// tile_ld(D)), from src: row j's D elements start at element row(j), each
// converted by cvt(value, 1); rows n..NROWS-1 are zero. Staged once a
// block, so plainly: a few 16-byte loads of a thread in flight at a time.
template <typename Dst, int NROWS, typename Src, typename Row, typename Cvt>
__device__ __forceinline__ void stage_one(Dst* __restrict__ dst,
                                         const Src* __restrict__ src,
                                         Row row, int n, int D, Cvt cvt) {
  constexpr int G = 16 / static_cast<int>(sizeof(Src));
  const int ld = tile_ld(D);
  const int cpr = D / G;
#pragma unroll 4
  for (int c = threadIdx.x; c < NROWS * cpr; c += THREADS) {
    const int j = c / cpr;
    const int col = (c - j * cpr) * G;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (j < n) raw = *reinterpret_cast<const uint4*>(src + row(j) + col);
    const Src* x = reinterpret_cast<const Src*>(&raw);
#pragma unroll
    for (int e = 0; e < G; ++e)
      dst[j * ld + col + e] = cvt(load_float(x[e]), 1.f);
  }
  zero_pad<Dst, NROWS>(dst, D);
}

// Stage rows [0, n) of two NROWS-row shared tiles of Dst (row stride
// tile_ld(D)), kt from k and vt from v: row j's D elements start at
// element row(j) of each, its scales are kscale(j) and vscale(j), each
// element is converted by cvt(value, scale); rows n..NROWS-1 are zero,
// and the pad columns too when D is 8 mod 16 (the last 16-deep mma step
// reads them). Each thread first puts all its 16-byte loads of both in
// flight, then stores them. D must be a multiple of 16 / sizeof(Src)
// elements and at most 8 * ND.
template <typename Dst, int NROWS, int ND, typename Src, typename Row,
          typename KScale, typename VScale, typename Cvt>
__device__ __forceinline__ void stage_rows(
    Dst* __restrict__ kt, Dst* __restrict__ vt, const Src* __restrict__ k,
    const Src* __restrict__ v, Row row, KScale kscale, VScale vscale, int n,
    int D, Cvt cvt) {
  constexpr int G = 16 / static_cast<int>(sizeof(Src));   // a chunk
  constexpr int PER = (NROWS * (8 * ND / G) + THREADS - 1) / THREADS;
  constexpr int BYTES = G * static_cast<int>(sizeof(Dst));
  static_assert(PER <= MAX_LOADS, "a thread's loads stay in registers");
  static_assert(BYTES % 8 == 0, "a converted chunk is whole 8-byte words");
  const int ld = tile_ld(D);
  const int cpr = D / G;
  uint4 raw[2][PER];
  float sc[2][PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int j = c / cpr;
    raw[0][i] = raw[1][i] = make_uint4(0u, 0u, 0u, 0u);
    sc[0][i] = sc[1][i] = 0.f;
    if (c < NROWS * cpr && j < n) {
      const size_t off = row(j) + (c - j * cpr) * G;
      raw[0][i] = *reinterpret_cast<const uint4*>(k + off);
      raw[1][i] = *reinterpret_cast<const uint4*>(v + off);
      sc[0][i] = kscale(j);
      sc[1][i] = vscale(j);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * THREADS;
    if (c >= NROWS * cpr) continue;
    const int j = c / cpr;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      alignas(16) Dst vals[G];
      if constexpr (std::is_same<Cvt, Copy>::value) {
        static_assert(std::is_same<Dst, Src>::value, "Copy keeps the dtype");
        *reinterpret_cast<uint4*>(vals) = raw[kv][i];
      } else {
        const Src* x = reinterpret_cast<const Src*>(&raw[kv][i]);
#pragma unroll
        for (int e = 0; e < G; ++e)
          vals[e] = cvt(load_float(x[e]), sc[kv][i]);
      }
      Dst* out = (kv ? vt : kt) + j * ld + (c - j * cpr) * G;
      if constexpr (BYTES % 16 == 0) {
#pragma unroll
        for (int w = 0; w < BYTES / 16; ++w)
          reinterpret_cast<uint4*>(out)[w] = reinterpret_cast<uint4*>(vals)[w];
      } else {
#pragma unroll
        for (int w = 0; w < BYTES / 8; ++w)
          reinterpret_cast<uint2*>(out)[w] = reinterpret_cast<uint2*>(vals)[w];
      }
    }
  }
  zero_pad<Dst, NROWS>(kt, D);
  zero_pad<Dst, NROWS>(vt, D);
}

// The K and V of one phase of the fold, staged as Dst: position p's D
// values start at element at(p) of k and of v, with the scales ks(p) and
// vs(p); each staged element is Cvt()(value, scale).
template <typename Dst, int ND, typename Cvt, typename Src, typename At,
          typename KScale, typename VScale>
struct Tiles {
  using Stored = Src;
  const Src* __restrict__ k;
  const Src* __restrict__ v;
  At at;
  KScale ks;
  VScale vs;

  // Positions [p0, p0 + n) into the first n rows of NROWS-row tiles.
  template <int NROWS>
  __device__ __forceinline__ void stage(Dst* kt, Dst* vt, int p0, int n,
                                        int D) const {
    stage_rows<Dst, NROWS, ND>(
        kt, vt, k, v, [&](int j) { return at(p0 + j); },
        [&](int j) { return ks(p0 + j); }, [&](int j) { return vs(p0 + j); },
        n, D, Cvt());
  }
};

template <typename Dst, int ND, typename Cvt, typename Src, typename At,
          typename KScale = NoScale, typename VScale = NoScale>
__device__ __forceinline__ Tiles<Dst, ND, Cvt, Src, At, KScale, VScale>
tiles(const Src* k, const Src* v, At at, KScale ks = KScale(),
      VScale vs = VScale()) {
  return {k, v, at, ks, vs};
}

// The running state of a warp's 16 query rows: this lane's rows g and
// g + 8 (g = lane / 4) in the mma accumulator layout.
template <int ND>
struct Fold {
  float m[2], l[2];
  float acc[ND][4];

  __device__ __forceinline__ void init() {
    m[0] = m[1] = NEG_BIG;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  // Fold one 64-key tile, the dots in T: q the warp's 16 rows, k and v
  // the shared tiles. attend(col, i) says whether key col of the tile
  // counts for this lane's row i (0: row g, 1: row g + 8); a masked score
  // is NEG_BIG. A row that masks a whole tile before it has folded any
  // key is left with m = NEG_BIG and a meaningless l and acc: its next
  // real tile scales them by corr = expf(NEG_BIG - m) = 0, and if none
  // comes, the merge weighs its split's state by that same 0.
  template <typename T, typename Attend>
  __device__ __forceinline__ void tile(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v, int D,
                                       float scale, int lane,
                                       Attend attend) {
    float s[NT][4];
    Mma<T>::abt(s, q, k, D, lane);
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = flash::frag_row(e);
        s[n][e] = attend(flash::frag_col(n, e, lane), i) ? s[n][e] * scale
                                                         : NEG_BIG;
        mx[i] = fmaxf(mx[i], s[n][e]);
      }
    }
    float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(flash::FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(flash::FULL, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new[i]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = flash::frag_row(e);
        s[n][e] = expf(s[n][e] - m_new[i]);
        sum[i] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(flash::FULL, sum[i], 1);
      sum[i] += __shfl_xor_sync(flash::FULL, sum[i], 2);
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
    Mma<T>::template rb<ND>(acc, s, v, D, lane);
  }
};

// One block's query rows [q0, q0 + QT) of one (row, head), q0 =
// blockIdx.x * QT. q and out point at the head's [S, D] rows; query i
// sits at chunk-local position qoff + i and attends the prefix [0, start)
// and the chunk keys [0, skc) at or before its position. prefix (Tiles of
// TP) serves prefix positions, chunk (Tiles of TQ) chunk positions; q is
// staged rounded to TP for the prefix and as given for the chunk.
template <typename TQ, typename TP, int ND, typename Prefix, typename Chunk>
__device__ __forceinline__ void prefill_rows(
    unsigned char* smem, const TQ* __restrict__ q, TQ* __restrict__ out,
    int S, int skc, int qoff, int start, int D, float scale,
    const Prefix& prefix, const Chunk& chunk) {
  using P = Plan<TQ, TP, typename Prefix::Stored, ND>;
  constexpr int KS = P::KS, QT = P::QT, SPAN = KS * KEYS;
  constexpr bool ONE_Q = std::is_same<TQ, TP>::value;
  const int ld = tile_ld(D);
  const int q0 = blockIdx.x * QT;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int split = warp / (PF_WARPS / KS);      // which tile of KS
  const int group = warp % (PF_WARPS / KS);      // which 16 rows
  TP* qp = reinterpret_cast<TP*>(smem);
  TQ* qq = ONE_Q ? reinterpret_cast<TQ*>(qp)
                 : reinterpret_cast<TQ*>(qp + QT * ld);
  unsigned char* kv = reinterpret_cast<unsigned char*>(
      ONE_Q ? static_cast<void*>(qp + QT * ld)
            : static_cast<void*>(qq + QT * ld));
  unsigned char* vv = kv + SPAN * ld * P::WIDE;

  // q, as the prefix's dots see it (rounded to TP) and as the chunk's do.
  auto qrow = [&](int j) { return static_cast<size_t>(q0 + j) * D; };
  const int nq = min(QT, S - q0);
  stage_one<TP, QT>(qp, q, qrow, nq, D, Rounded<TP, TP>());
  if constexpr (!ONE_Q)
    stage_one<TQ, QT>(qq, q, qrow, nq, D, Rounded<TQ, TQ>());

  // This warp's rows: w0 .. w0 + 15; live while one is a real query.
  const int w0 = q0 + group * ROWS;
  const bool live = w0 < S;
  const int g = lane >> 2;
  const int pos[2] = {qoff + w0 + g, qoff + w0 + g + 8};
  const int w_last = qoff + min(S, w0 + ROWS) - 1;
  Fold<ND> st;
  st.init();

  // The prefix: KS tiles a step, this warp's the split-th of them.
  TP* kp = reinterpret_cast<TP*>(kv);
  TP* vp = reinterpret_cast<TP*>(vv);
  for (int base = 0; base < start; base += SPAN) {
    __syncthreads();
    prefix.template stage<SPAN>(kp, vp, base, min(SPAN, start - base), D);
    __syncthreads();
    const int t0 = base + split * KEYS;
    const int n = min(KEYS, start - t0);
    if (live && n > 0)
      st.template tile<TP>(qp + group * ROWS * ld, kp + split * KEYS * ld,
                           vp + split * KEYS * ld, D, scale, lane,
                           [&](int col, int) { return col < n; });
  }

  // The chunk, causally, up to the block's last real query.
  TQ* kc = reinterpret_cast<TQ*>(kv);
  TQ* vc = reinterpret_cast<TQ*>(vv);
  const int c_end = min(skc, qoff + min(S, q0 + QT));
  for (int base = 0; base < c_end; base += SPAN) {
    __syncthreads();
    chunk.template stage<SPAN>(kc, vc, base, min(SPAN, c_end - base), D);
    __syncthreads();
    const int c0 = base + split * KEYS;
    const int n = min(KEYS, skc - c0);
    if (live && c0 < c_end && c0 <= w_last)
      st.template tile<TQ>(qq + group * ROWS * ld, kc + split * KEYS * ld,
                           vc + split * KEYS * ld, D, scale, lane,
                           [&](int col, int i) {
                             return col < n && c0 + col <= pos[i];
                           });
  }

  // Merge the splits' states, split by split in order: per split s and
  // block row r, [m, l, acc[D]] at merge + (s * QT + r) * (D + 2).
  float* merge = reinterpret_cast<float*>(kv);
  __syncthreads();
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* row = merge + (split * QT + group * ROWS + g + 8 * i) * (D + 2);
    if (t == 0) {
      row[0] = st.m[i];
      row[1] = st.l[i];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (8 * n < D) {
        row[2 + 8 * n + 2 * t] = st.acc[n][2 * i];
        row[3 + 8 * n + 2 * t] = st.acc[n][2 * i + 1];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    float m = NEG_BIG;
#pragma unroll
    for (int s = 0; s < KS; ++s) m = fmaxf(m, merge[(s * QT + r) * (D + 2)]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const float* row = merge + (s * QT + r) * (D + 2);
      const float w = expf(row[0] - m);
      l += row[1] * w;
      acc += row[2 + d] * w;
    }
    out[static_cast<size_t>(q0 + r) * D + d] =
        from_float<TQ>(acc / finalize_denom(l));
  }
}

}  // namespace prefill
}  // namespace nezha
