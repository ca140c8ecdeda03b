// Deterministic bucketing of rows by target index, for the segment-sum
// kernels (scatter_rows.cu, chamfer_bwd.cu).
//
// A segment-sum out[t] = sum_{r : idx[r] == t} g[r] written with fp32
// atomicAdd gives different bits from run to run, because the order of the
// additions changes. Instead, one block per cloud sorts the row ids by target
// with a stable counting sort, and a second kernel sums each target's rows in
// increasing row order: the same inputs give the same bits on every run.
//
// After bucket_rows, the rows whose target is t are
//     perm[end[t - 1] .. end[t])      (end[-1] taken as 0)
// in increasing row order. Rows whose index lies outside [0, n) are left out.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segsum {

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;

// Inclusive sum of one int per thread over the block. Thread
// kSortThreads - 1 receives the block's total.
__device__ __forceinline__ int block_inclusive_sum(int v, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kSortWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < kSortWarps) s_warp[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += s_warp[warp - 1];
  return v;
}

// Stable counting sort of the rows 0 .. rows-1 of one cloud by idx[r], run
// by one block of kSortThreads threads. `end` (n ints) and `perm` (rows
// ints) are this block's own scratch in device memory.
__device__ void bucket_rows(const int* __restrict__ idx, int rows, int n,
                            int* __restrict__ end, int* __restrict__ perm) {
  __shared__ int s_warp[kSortWarps];
  __shared__ int s_carry;

  // 1. counts (integer atomics: the counts do not depend on the order)
  for (int t = threadIdx.x; t < n; t += kSortThreads) end[t] = 0;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kSortThreads) {
    const int t = idx[r];
    if (t >= 0 && t < n) atomicAdd(&end[t], 1);
  }
  __syncthreads();

  // 2. exclusive scan: end[t] becomes the first slot of bucket t
  for (int base = 0; base < n; base += kSortThreads) {
    const int t = base + threadIdx.x;
    const int cnt = t < n ? end[t] : 0;
    const int incl = block_inclusive_sum(cnt, s_warp);
    const int carry = s_carry;
    if (t < n) end[t] = carry + incl - cnt;
    __syncthreads();  // every thread has read s_carry and s_warp
    if (threadIdx.x == kSortThreads - 1) s_carry = carry + incl;
    __syncthreads();
  }

  // 3. stable placement. The warps of a chunk take turns, in row order; in a
  // warp, lanes with the same target find each other with __match_any_sync
  // and take consecutive slots by lane (= row) order. Afterwards end[t] is
  // one past the last slot of bucket t.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int base = 0; base < rows; base += kSortThreads) {
    const int r = base + threadIdx.x;
    int t = r < rows ? idx[r] : -1;
    if (t < 0 || t >= n) t = -1;  // dropped rows form their own group
    for (int w = 0; w < kSortWarps; ++w) {
      if (warp == w) {
        const unsigned peers = __match_any_sync(0xffffffffu, t);
        const int slot = t >= 0 ? end[t] : 0;
        __syncwarp();  // every lane has read end[t] before it moves
        if (t >= 0) {
          perm[slot + __popc(peers & lower)] = r;
          if ((peers & lower) == 0) end[t] = slot + __popc(peers);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace segsum
