// The first-k ball selection of ball_group.cu and group_gather.cu.
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

// The same selection over a cloud staged in shared memory, for a block that
// serves many centroids (ball_group.cu), for kCents centroids of a warp at
// once: each point read from shared memory once serves all of them. Four
// batches of 32 points a round, their tests in flight together; the slots
// of a centroid placed only for a batch with one of its in-ball points;
// without a mask no penalty add (0 + d^2 is d^2 exactly). The same points in
// the same order, so the same slots as select_first_k; the sweep runs until
// every centroid has k (it may test up to 127 points past a centroid's k-th
// in-ball one, and past it for a centroid done sooner). Centroid m writes
// slots[m * k ..] and returns its in-ball count (at most k) in cnt[m]; a
// centroid whose cnt[m] starts at k is left alone.
template <bool kMasked, int kCents>
__device__ __forceinline__ void select_staged(const float4* shared_points, int n,
                                              const float (&cx)[kCents][3], float r2,
                                              int k, int* slots, int (&cnt)[kCents],
                                              int lane) {
  constexpr int kBatches = 4;
  const unsigned lower = (1u << lane) - 1u;
  bool busy = false;
#pragma unroll
  for (int m = 0; m < kCents; ++m) busy |= cnt[m] < k;
  for (int base = 0; base < n && busy; base += 32 * kBatches) {
    unsigned ball[kCents][kBatches];
#pragma unroll
    for (int u = 0; u < kBatches; ++u) {
      const int i = base + 32 * u + lane;
      const float4 p = i < n ? shared_points[i] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < kCents; ++m) {
        const float dx = __fsub_rn(cx[m][0], p.x);
        const float dy = __fsub_rn(cx[m][1], p.y);
        const float dz = __fsub_rn(cx[m][2], p.z);
        float acc = kMasked ? __fadd_rn(p.w, __fmul_rn(dx, dx)) : __fmul_rn(dx, dx);
        acc = __fadd_rn(acc, __fmul_rn(dy, dy));
        acc = __fadd_rn(acc, __fmul_rn(dz, dz));
        ball[m][u] = __ballot_sync(0xffffffffu, i < n && acc <= r2);
      }
    }
    busy = false;
#pragma unroll
    for (int m = 0; m < kCents; ++m) {
#pragma unroll
      for (int u = 0; u < kBatches; ++u) {
        if (ball[m][u] != 0u) {  // warp-uniform
          const int rank = cnt[m] + __popc(ball[m][u] & lower);
          if (((ball[m][u] >> lane) & 1u) && rank < k)
            slots[m * k + rank] = base + 32 * u + lane;
          cnt[m] += __popc(ball[m][u]);
        }
      }
      busy |= cnt[m] < k;
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kCents; ++m) {
    cnt[m] = min(cnt[m], k);
    const int slot0 = cnt[m] > 0 ? slots[m * k] : 0;
    for (int j = cnt[m] + lane; j < k; j += 32) slots[m * k + j] = slot0;
  }
  __syncwarp();
}

}  // namespace ball_select
