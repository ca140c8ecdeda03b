// The first-k ball selection shared by ball_group.cu and group_gather.cu.
//
// A point is inside the ball of a centroid when ((pen + dx^2) + dy^2) + dz^2
// <= r2, with d the centroid minus the point, pen = 1e9 on masked points and
// 0 elsewhere, and r2 = float32(radius * radius) taken in double by the
// caller: the TPU kernels' formula and order, with rounded intrinsics so no
// FMA contraction moves a point across the radius.
//
// One warp selects for one centroid: it sweeps the points in index order, 32
// at a time; a ballot of the in-ball lanes and a popcount prefix place the
// first k of them into their slots, and the sweep stops once k are found.
// Slots past the in-ball count then repeat slot 0 (point 0 when the ball is
// empty).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ball_select {

constexpr float kPen = 1e9f;
// a cloud of up to this many points is staged in shared memory as
// (x, y, z, pen): 48 KB
constexpr int kMaxSharedPoints = 3072;

__device__ __forceinline__ float4 load_point(const float* xyz,
                                             const uint8_t* mask, int64_t i) {
  const float pen = (mask == nullptr || mask[i] != 0) ? 0.f : kPen;
  return make_float4(xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2], pen);
}

// Stage the cloud's points (x, y, z, pen) into shared memory; every thread of
// the block takes part and waits at the barrier.
__device__ __forceinline__ void stage_points(float4* shared_points,
                                             const float* xb, const uint8_t* mb,
                                             int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    shared_points[i] = load_point(xb, mb, i);
  }
  __syncthreads();
}

// The warp's selection for the centroid (cx, cy, cz): writes the k slots of
// `slots` (global memory, read back by every lane after the final
// __syncwarp) and returns the in-ball count, at most k.
template <bool kShared>
__device__ __forceinline__ int select_first_k(
    const float4* shared_points, const float* xb, const uint8_t* mb, int n,
    float cx, float cy, float cz, float r2, int k, int* slots, int lane) {
  int cnt = 0;
  for (int base = 0; base < n && cnt < k; base += 32) {
    const int i = base + lane;
    bool in = false;
    if (i < n) {
      const float4 p = kShared ? shared_points[i] : load_point(xb, mb, i);
      const float dx = __fsub_rn(cx, p.x);
      const float dy = __fsub_rn(cy, p.y);
      const float dz = __fsub_rn(cz, p.z);
      float acc = __fadd_rn(p.w, __fmul_rn(dx, dx));
      acc = __fadd_rn(acc, __fmul_rn(dy, dy));
      acc = __fadd_rn(acc, __fmul_rn(dz, dz));
      in = acc <= r2;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, in);
    const int rank = cnt + __popc(ball & ((1u << lane) - 1u));
    if (in && rank < k) slots[rank] = i;
    cnt += __popc(ball);
  }
  cnt = min(cnt, k);
  __syncwarp();
  const int slot0 = cnt > 0 ? slots[0] : 0;
  for (int j = cnt + lane; j < k; j += 32) slots[j] = slot0;
  __syncwarp();
  return cnt;
}

}  // namespace ball_select
