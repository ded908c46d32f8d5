// What the split decode kernels share: the dense flash-decode
// (flash_decode.cu, B6), the float paged decode (paged_decode.cu, B7) and
// the int8 paged decode (paged_quant_decode.cu, B8) cut each row's keys
// into splits of a compile-time size, one block each, stage a split with
// cp.async, and merge the splits' fp32 partials in the same launch.
//
// The merge: each split with keys writes its partial (acc[D], m, l) to a
// workspace the wrapper allocates; the last block of a (row, head) to
// arrive (B6: every split; B7 and B8: the splits with keys, or split 0
// alone of an empty row), found by a per-(row, head) counter that it
// resets to 0, merges the row's splits in split order with the
// log-sum-exp combine and writes acc / max(l, 1e-30) in q's dtype. The
// counter is the only atomic; the data never goes through one, and since
// the merge always runs in split order the output is bitwise the same
// from run to run, whichever block arrives last. A row with no live split
// writes exact zeros.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace nezha {

// Copy 16 bytes global -> shared without registers (cp.async, L2 only);
// `bytes` < 16 fills the rest with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The fp32 partial of one split: acc[D], then m, then l.
__device__ __forceinline__ int part_floats(int D) { return D + 2; }

// Count this block's arrival at (row, head) bh, once its partial (if it
// had keys) is written; the last of the `arrivals` blocks that arrive
// there merges the row's first n_live partials (row_parts: one
// part_floats(D) each, in split order) into out[bh * D ...]. Called by
// all THREADS threads of the block; last_sm is a __shared__ int of the
// kernel's.
template <int THREADS, typename TQ>
__device__ __forceinline__ void arrive_and_merge(
    const float* __restrict__ row_parts, int* __restrict__ counters,
    TQ* __restrict__ out, size_t bh, int arrivals, int n_live, int D,
    int& last_sm) {
  const int tid = threadIdx.x;
  // The fences make this block's partial visible before its arrival is
  // counted.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int seen = atomicAdd(counters + bh, 1);
    last_sm = seen == arrivals - 1;
    if (last_sm) counters[bh] = 0;   // ready for the next call
  }
  __syncthreads();
  if (!last_sm) return;
  __threadfence();
  // Unrolled so that the splits' loads are in flight together; the sums
  // still run in split order.
  float m = NEG_BIG;
#pragma unroll 8
  for (int s = 0; s < n_live; ++s)
    m = fmaxf(m, __ldcg(row_parts + s * part_floats(D) + D));
  for (int d = tid; d < D; d += THREADS) {
    float l = 0.f, a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) {
      const float* part = row_parts + s * part_floats(D);
      const float c = expf(__ldcg(part + D) - m);
      l = fmaf(__ldcg(part + D + 1), c, l);
      a = fmaf(__ldcg(part + d), c, a);
    }
    out[bh * D + d] = from_float<TQ>(a / finalize_denom(l));
  }
}

// The grid of a kernel library's last launch (x, y, z), for a caller that
// reports what ran; each library that includes this keeps its own.
inline int last_grid[3] = {0, 0, 0};

inline void record_grid(const dim3& grid) {
  last_grid[0] = grid.x;
  last_grid[1] = grid.y;
  last_grid[2] = grid.z;
}

}  // namespace nezha
