// Fused backward of the Chamfer nearest-neighbour distances (sm_90a).
//
// Replaces pointcloud_tpu/ops/pallas_kernels.py:_chamfer_bwd_kernel (reached
// through chamfer_nn_bwd_pallas). For clouds x (B, N, C), y (B, M, C) fp32,
// C <= 8, the cotangents gx (B, N), gy (B, M) of the two min-distance vectors
// (already zero on masked rows) and the argmins amin_x (B, N), amin_y (B, M):
//     tx = 2 gx (x - y[amin_x])              ty = 2 gy (y - x[amin_y])
//     dx = tx - segsum(ty -> amin_y)         dy = ty - segsum(tx -> amin_x)
// both fp32. Indices must lie in range (they come from the forward sweep).
//
// Design, in one fixed sequence of two launches:
//   1. one block per (cloud, direction) sorts the rows of the other cloud by
//      their argmin with a stable counting sort (segsum.cuh): the y rows by
//      amin_y into N buckets and the x rows by amin_x into M buckets;
//   2. one thread per point (blockIdx.z picks x or y) forms its own term
//      (one indexed load of its nearest neighbour) and subtracts the terms of
//      the rows in its bucket in increasing row order. A row j in x-point i's
//      bucket has amin_y[j] == i, so its term 2 gy_j (y_j - x_i) needs no
//      gather. No fp32 atomics: the same inputs give the same bits every run,
//      in the order of the JAX package's .at[].add composition.
// The TPU kernel builds one-hot (N, M) selectors and runs the gathers and
// segment-sums as MXU products in a C-major layout (for the MXU's lane
// padding); on the card gathers are indexed loads and sums are fixed-order
// loops, O(N + M) per cloud instead of O(N M).
//
// Bound on the card: bytes. Each input is read once and dx, dy written once
// (about 59 MB at B=256, N=M=2048, C=6: 0.018 ms at 3.35 TB/s); the
// arithmetic is ~6C operations per point.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segsum.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(segsum::kSortThreads)
    sort_kernel(const int* __restrict__ amin_x, const int* __restrict__ amin_y,
                int* end_x, int* perm_y, int* end_y, int* perm_x, int n,
                int m) {
  const int64_t b = blockIdx.x;
  if (blockIdx.y == 0) {  // y rows into the N buckets of the x points
    segsum::bucket_rows(amin_y + b * m, m, n, end_x + b * n, perm_y + b * m);
  } else {  // x rows into the M buckets of the y points
    segsum::bucket_rows(amin_x + b * n, n, m, end_y + b * m, perm_x + b * n);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const int* __restrict__ amin_x, const int* __restrict__ amin_y,
    const int* __restrict__ end_x, const int* __restrict__ perm_y,
    const int* __restrict__ end_y, const int* __restrict__ perm_x,
    float* __restrict__ dx, float* __restrict__ dy, int n, int m) {
  const bool x_side = blockIdx.z == 0;
  const int np = x_side ? n : m;  // points of this side
  const int nq = x_side ? m : n;  // points of the other side
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= np) return;
  const int64_t b = blockIdx.y;
  const float* p = (x_side ? x : y) + b * np * C;
  const float* q = (x_side ? y : x) + b * nq * C;
  const float* gp = (x_side ? gx : gy) + b * np;
  const float* gq = (x_side ? gy : gx) + b * nq;
  const int* amin_p = (x_side ? amin_x : amin_y) + b * np;
  const int* end = (x_side ? end_x : end_y) + b * np;
  const int* perm = (x_side ? perm_y : perm_x) + b * nq;

  float pv[C], acc[C];
  const int j = amin_p[i];
  const float s = 2.0f * gp[i];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    pv[c] = p[static_cast<int64_t>(i) * C + c];
    acc[c] = s * (pv[c] - q[static_cast<int64_t>(j) * C + c]);
  }
  const int lo = i > 0 ? end[i - 1] : 0;
  const int hi = end[i];
  for (int k = lo; k < hi; ++k) {
    const int r = perm[k];
    const float sr = 2.0f * gq[r];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] -= sr * (q[static_cast<int64_t>(r) * C + c] - pv[c]);
    }
  }
  float* out = (x_side ? dx : dy) + b * np * C;
#pragma unroll
  for (int c = 0; c < C; ++c) out[static_cast<int64_t>(i) * C + c] = acc[c];
}

template <int C>
cudaError_t launch_combine(const float* x, const float* y, const float* gx,
                           const float* gy, const int* amin_x,
                           const int* amin_y, const int* end_x,
                           const int* perm_y, const int* end_y,
                           const int* perm_x, float* dx, float* dy, int b,
                           int n, int m, cudaStream_t s) {
  const int longest = n > m ? n : m;
  const dim3 grid((longest + kThreads - 1) / kThreads, b, 2);
  combine_kernel<C><<<grid, kThreads, 0, s>>>(x, y, gx, gy, amin_x, amin_y,
                                              end_x, perm_y, end_y, perm_x,
                                              dx, dy, n, m);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors;
// end_x (B, N), perm_y (B, M), end_y (B, M), perm_x (B, N) are int32
// scratch. Returns the CUDA error of the launches (0 on success); the caller
// checked the bounds (1 <= C <= 8, B <= 65535).
extern "C" int chamfer_bwd_launch(const float* x, const float* y,
                                  const float* gx, const float* gy,
                                  const int* amin_x, const int* amin_y,
                                  float* dx, float* dy, int* end_x,
                                  int* perm_y, int* end_y, int* perm_x, int b,
                                  int n, int m, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sort_kernel<<<dim3(b, 2), segsum::kSortThreads, 0, s>>>(
      amin_x, amin_y, end_x, perm_y, end_y, perm_x, n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
#define CHAMFER_BWD_CASE(C_)                                                   \
  case C_:                                                                     \
    return static_cast<int>(launch_combine<C_>(x, y, gx, gy, amin_x, amin_y,   \
                                               end_x, perm_y, end_y, perm_x,   \
                                               dx, dy, b, n, m, s));
  switch (c) {
    CHAMFER_BWD_CASE(1)
    CHAMFER_BWD_CASE(2)
    CHAMFER_BWD_CASE(3)
    CHAMFER_BWD_CASE(4)
    CHAMFER_BWD_CASE(5)
    CHAMFER_BWD_CASE(6)
    CHAMFER_BWD_CASE(7)
    CHAMFER_BWD_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CHAMFER_BWD_CASE
}
