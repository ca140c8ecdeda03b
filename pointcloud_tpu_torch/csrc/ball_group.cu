// Ball query + centred gather in SetAbstraction's input layout (sm_90a).
//
// Replaces pointcloud_tpu/ops/pallas_kernels.py:_group_ball_smajor_kernel
// (reached through grouped_gather_ball). For clouds xyz (B, N, 3) fp32,
// features (B, N, F) fp32 or bf16 (or none, F = 0), centroids (B, S, 3) fp32
// and an optional validity mask (B, N), writes
//   grouped (B, S, k, 3+F) in the features' dtype: [xyz[idx] - centroid |
//     feats[idx]], the centred xyz computed in fp32 and rounded once, the
//     features copied bit for bit;
//   idx (B, S, k) int32: the first k points inside the ball in index order,
//     slots past the in-ball count repeating slot 0 (point 0 when the ball
//     is empty);
//   valid (B, S, k) bool: slot j < in-ball count.
// Membership and selection are ball_select.cuh's, shared with group_gather.cu:
// a point is inside when ((pen + dx^2) + dy^2) + dz^2 <= r2 (the TPU kernel's
// formula and order, in rounded intrinsics).
//
// Design: one warp per centroid, 16 centroids of one cloud per block. A
// cloud of up to kMaxSharedPoints points is staged in shared memory as
// (x, y, z, pen); a larger one is read from global memory. The warp sweeps
// the points in index order, 32 at a time: a ballot of the in-ball lanes and
// a popcount prefix place the first k of them into their slots, and the
// sweep stops once k are found (the TPU kernel ranks all N with a
// prefix-count matrix product). The warp then pads the slots and writes its
// k output rows as one contiguous run of k * (3+F) elements, lanes on
// consecutive elements.
//
// Bound on the card: bytes. The grouped rows are the bulk of the traffic
// (B*S*k*(3+F) elements written once); the distance tests, ~9 operations a
// point up to the k-th in-ball point, are far below the card's fp32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ball_select.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
using ball_select::kMaxSharedPoints;

__device__ __forceinline__ float to_out(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
    ball_group_kernel(const float* __restrict__ xyz, const T* __restrict__ feats,
                      const float* __restrict__ cents,
                      const uint8_t* __restrict__ mask, int n, int s_count,
                      int k, int f, float r2, T* __restrict__ out, int* idx,
                      bool* __restrict__ valid) {
  __shared__ float4 shared_points[kShared ? kMaxSharedPoints : 1];
  const int64_t b = blockIdx.y;
  const float* xb = xyz + b * n * 3;
  const uint8_t* mb = mask != nullptr ? mask + b * n : nullptr;
  if (kShared) ball_select::stage_points(shared_points, xb, mb, n);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= s_count) return;  // no block-wide barrier follows

  const int64_t row = b * s_count + s;
  const float cx = cents[3 * row];
  const float cy = cents[3 * row + 1];
  const float cz = cents[3 * row + 2];
  // this centroid's slots; read back by other lanes after __syncwarp
  int* slots = idx + row * k;

  const int cnt = ball_select::select_first_k<kShared>(
      shared_points, xb, mb, n, cx, cy, cz, r2, k, slots, lane);
  for (int j = lane; j < k; j += 32) valid[row * k + j] = j < cnt;

  // k rows of c = 3 + f channels, element e = j * c + ch, lanes consecutive
  const int c = 3 + f;
  const int64_t total = static_cast<int64_t>(k) * c;
  T* ob = out + row * total;
  const T* fb = feats != nullptr ? feats + b * n * static_cast<int64_t>(f) : nullptr;
  int j = lane / c;
  int ch = lane - j * c;
  for (int64_t e = lane; e < total; e += 32) {
    const int p = slots[j];
    T v;
    if (ch < 3) {
      const float coord = kShared ? (ch == 0 ? shared_points[p].x
                                    : ch == 1 ? shared_points[p].y
                                              : shared_points[p].z)
                                  : xb[3 * static_cast<int64_t>(p) + ch];
      const float centre = ch == 0 ? cx : ch == 1 ? cy : cz;
      v = to_out(__fsub_rn(coord, centre), T());
    } else {
      v = fb[static_cast<int64_t>(p) * f + (ch - 3)];
    }
    ob[e] = v;
    ch += 32;
    while (ch >= c) {
      ch -= c;
      ++j;
    }
  }
}

template <typename T>
cudaError_t launch(const float* xyz, const void* feats, const float* cents,
                   const uint8_t* mask, int b, int n, int s_count, int k, int f,
                   float r2, void* out, int* idx, bool* valid,
                   cudaStream_t stream) {
  const dim3 grid((s_count + kWarps - 1) / kWarps, b);
  const T* fp = static_cast<const T*>(feats);
  T* op = static_cast<T*>(out);
  if (n <= kMaxSharedPoints) {
    ball_group_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xyz, fp, cents, mask, n, s_count, k, f, r2, op, idx, valid);
  } else {
    ball_group_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xyz, fp, cents, mask, n, s_count, k, f, r2, op, idx, valid);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// xyz (B, N, 3) f32, feats (B, N, F) f32 (feats_bf16 == 0) or bf16, or null
// with F = 0, cents (B, S, 3) f32, mask (B, N) bool or null; out
// (B, S, k, 3+F) in the features' dtype (f32 without features), idx
// (B, S, k) i32, valid (B, S, k) bool. Returns the CUDA error of the launch
// (0 on success); the caller checked the bounds (B <= 65535).
extern "C" int ball_group_launch(const float* xyz, const void* feats,
                                 int feats_bf16, const float* cents,
                                 const uint8_t* mask, int b, int n, int s_count,
                                 int k, int f, float r2, void* out, int* idx,
                                 bool* valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      feats_bf16 ? launch<__nv_bfloat16>(xyz, feats, cents, mask, b, n, s_count,
                                         k, f, r2, out, idx, valid, st)
                 : launch<float>(xyz, feats, cents, mask, b, n, s_count, k, f,
                                 r2, out, idx, valid, st);
  return static_cast<int>(err);
}
