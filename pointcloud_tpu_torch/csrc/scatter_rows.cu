// Deterministic segment-sum of rows onto target indices (sm_90a).
//
// Replaces pointcloud_tpu/ops/pallas_kernels.py:_scatter_kernel and
// _scatter_kernel_init (reached through scatter_rows_pallas). For g (B, R, C)
// in fp32 or bf16, idx (B, R) int32 and an optional fp32 init (B, n, C):
//     out[b, t, :] = init[b, t, :] + sum_{r : idx[b, r] == t} g[b, r, :]
// in fp32 (B, n, C). Rows whose index lies outside [0, n) are dropped, as the
// TPU kernel's one-hot rows drop them.
//
// Determinism: no fp32 atomics. Launch 1 sorts each cloud's rows by target
// with a stable counting sort (segsum.cuh; one block per cloud). Launch 2
// gives each output element one thread, which starts from init and adds its
// target's rows in increasing row order: the same inputs give the same bits
// on every run, and the order is the one CPU index_add_ uses.
//
// The TPU kernel computes the sum as one-hot (n, R-tile) @ g MXU products and
// can fold split-bf16 copies of g back to fp32 (`fold`); the CUDA cores add
// fp32 directly, so neither is carried over.
//
// Bound on the card: bytes. Each of g, idx, init and out is read or written
// once (plus the sort's 4-byte row ids and counts), and there is one addition
// per element of g: far below the card's operation rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segsum.cuh"

namespace {

constexpr int kSumThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__global__ void __launch_bounds__(segsum::kSortThreads)
    sort_kernel(const int* __restrict__ idx, int rows, int n, int* end,
                int* perm) {
  const int64_t b = blockIdx.x;
  segsum::bucket_rows(idx + b * rows, rows, n, end + b * n, perm + b * rows);
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    sum_kernel(const T* __restrict__ g, const float* __restrict__ init,
               const int* __restrict__ end, const int* __restrict__ perm,
               float* __restrict__ out, int rows, int n, int c) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t per_cloud = static_cast<int64_t>(n) * c;
  if (e >= per_cloud) return;
  const int t = static_cast<int>(e / c);
  const int ch = static_cast<int>(e - static_cast<int64_t>(t) * c);
  const int* eb = end + b * n;
  const int* pb = perm + b * rows;
  const T* gb = g + b * rows * static_cast<int64_t>(c);
  const int lo = t > 0 ? eb[t - 1] : 0;
  const int hi = eb[t];
  float acc = init != nullptr ? init[b * per_cloud + e] : 0.f;
  for (int k = lo; k < hi; ++k) {
    acc += to_float(gb[static_cast<int64_t>(pb[k]) * c + ch]);
  }
  out[b * per_cloud + e] = acc;
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// g (B, R, C) fp32 (g_bf16 == 0) or bf16, idx (B, R) i32, init (B, n, C) f32
// or null, out (B, n, C) f32; `end` (B, n) and `perm` (B, R) int32 scratch.
// Returns the CUDA error of the launches (0 on success); the caller checked
// the bounds (B <= 65535, n * C < 2^31 / 256 blocks).
extern "C" int scatter_rows_launch(const void* g, int g_bf16, const int* idx,
                                   const float* init, float* out, int* end,
                                   int* perm, int b, int rows, int n, int c,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sort_kernel<<<b, segsum::kSortThreads, 0, s>>>(idx, rows, n, end, perm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per_cloud = static_cast<int64_t>(n) * c;
  const dim3 grid(static_cast<unsigned>((per_cloud + kSumThreads - 1) / kSumThreads), b);
  if (g_bf16) {
    sum_kernel<__nv_bfloat16><<<grid, kSumThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), init, end, perm, out, rows, n, c);
  } else {
    sum_kernel<float><<<grid, kSumThreads, 0, s>>>(
        static_cast<const float*>(g), init, end, perm, out, rows, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}
