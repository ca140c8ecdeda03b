// Farthest-point sampling (sm_90a).
//
// Replaces pointcloud_tpu/ops/pallas_kernels.py:_fps_kernel (reached through
// farthest_point_sample_pallas). For clouds xyz (B, N, C >= 3) fp32 and an
// optional validity mask (B, N), writes idx (B, K) int32: slot 0 is the
// first valid point (0 if point 0 is valid; 0 if no point is), and each
// later slot the point whose squared distance to the selected set, over the
// first 3 dims, is largest, the lowest index winning ties. The running
// minimum `mind` starts at 1e10 on valid points and -1 on masked ones, which
// keep -1: valid points always hold mind >= 0, so a masked point is chosen
// only in a cloud without any valid point (then every slot is 0). A cloud
// with fewer valid points than K repeats valid points (their mind is 0).
//
// Design: one thread block per cloud, since the K steps are sequential. The
// block keeps (x, y, z, mind) of every point in shared memory when the cloud
// fits (N <= kMaxSharedPoints, 16 bytes a point), else in a global scratch
// that stays in L2. Each step updates mind over the block's points, takes a
// block-wide argmax on (value, index) with warp shuffles and one exchange
// through shared memory, and broadcasts the winner, which is read back as
// the next step's centre.
//
// Exactness: FPS is chaotic, so the distance is computed with rounded
// intrinsics in the TPU kernel's order, ((dx*dx + dy*dy) + dz*dz), with no
// FMA contraction; the plain version computes the same separate operations,
// and the two give equal indices.
//
// Bound on the card: operations, about 9 per (step, point): B*(K-1)*N*9 fp32
// operations at the card's fp32 rate. What actually binds it is the K-1
// serial block reductions (two barriers each): one block per cloud leaves
// the card idle for few clouds, and the sensor's single cloud of ~2e5 points
// streams its 3 MB working set from L2 on one SM every step. Thread block
// clusters with distributed shared memory would spread one cloud over
// several SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxSharedPoints = 12288;  // 192 KB of (x, y, z, mind)

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide argmax on (v, i), lowest i on ties; every thread returns it.
template <int kThreads>
__device__ __forceinline__ int block_argmax(float v, int i, float* warp_v,
                                            int* warp_i, int* winner) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    take_better(v, i, __shfl_down_sync(0xffffffffu, v, off),
                __shfl_down_sync(0xffffffffu, i, off));
  }
  if (lane == 0) {
    warp_v[warp] = v;
    warp_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_v[lane] : -INFINITY;
    i = lane < kWarps ? warp_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      take_better(v, i, __shfl_down_sync(0xffffffffu, v, off),
                  __shfl_down_sync(0xffffffffu, i, off));
    }
    if (lane == 0) *winner = i;
  }
  __syncthreads();
  return *winner;
}

template <bool kShared, int kThreads>
__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, int c,
               const uint8_t* __restrict__ mask, int n, int k,
               float4* __restrict__ work, int* __restrict__ out) {
  extern __shared__ float4 shared_points[];
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  __shared__ int winner;

  const int64_t b = blockIdx.x;
  float4* pts = kShared ? shared_points : work + b * n;
  const float* xb = xyz + b * n * static_cast<int64_t>(c);
  const uint8_t* mb = mask != nullptr ? mask + b * n : nullptr;
  int* ob = out + b * k;

  // stage the cloud; the first valid index of this thread's points
  bool any_valid = false;
  int first = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool valid = mb == nullptr || mb[i] != 0;
    const float* p = xb + static_cast<int64_t>(i) * c;
    pts[i] = make_float4(p[0], p[1], p[2], valid ? 1e10f : -1.f);
    if (valid && !any_valid) {
      any_valid = true;
      first = i;
    }
  }
  // (1, first) beats every (0, 0): the lowest valid index, else 0
  int last = block_argmax<kThreads>(any_valid ? 1.f : 0.f, first, warp_v,
                                    warp_i, &winner);
  if (threadIdx.x == 0) ob[0] = last;

  for (int s = 1; s < k; ++s) {
    const float lx = pts[last].x;
    const float ly = pts[last].y;
    const float lz = pts[last].z;
    float best_v = -INFINITY;
    int best_i = INT_MAX;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      float m = pts[i].w;
      if (m >= 0.f) {  // valid points only; masked ones keep -1
        const float dx = __fsub_rn(pts[i].x, lx);
        const float dy = __fsub_rn(pts[i].y, ly);
        const float dz = __fsub_rn(pts[i].z, lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        m = fminf(m, d);
        pts[i].w = m;
      }
      if (m > best_v) {  // strict: this thread's lowest index on ties
        best_v = m;
        best_i = i;
      }
    }
    last = block_argmax<kThreads>(best_v, best_i, warp_v, warp_i, &winner);
    if (threadIdx.x == 0) ob[s] = last;
  }
}

template <bool kShared, int kThreads>
cudaError_t launch(const float* xyz, int c, const uint8_t* mask, int b, int n,
                   int k, float4* work, int* out, cudaStream_t stream) {
  const size_t smem = kShared ? static_cast<size_t>(n) * sizeof(float4) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<kShared, kThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<kShared, kThreads><<<b, kThreads, smem, stream>>>(
      xyz, c, mask, n, k, work, out);
  return cudaGetLastError();
}

}  // namespace

// Floats of global scratch one cloud of n points needs (0: it fits in
// shared memory and the launch takes no scratch).
extern "C" int fps_scratch_floats(int n) {
  return n <= kMaxSharedPoints ? 0 : 4 * n;
}

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// xyz (B, N, C) f32, mask (B, N) bool or null, work (B, 4N) f32 scratch when
// fps_scratch_floats(N) > 0 (else null), out (B, K) i32. Returns the CUDA
// error of the launch (0 on success); the caller checked the bounds.
extern "C" int fps_launch(const float* xyz, int c, const uint8_t* mask, int b,
                          int n, int k, float* work, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* w = reinterpret_cast<float4*>(work);
  cudaError_t err;
  if (n <= kMaxSharedPoints) {
    err = n > 4096 ? launch<true, 1024>(xyz, c, mask, b, n, k, w, out, s)
                   : launch<true, 256>(xyz, c, mask, b, n, k, w, out, s);
  } else {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = launch<false, 1024>(xyz, c, mask, b, n, k, w, out, s);
  }
  return static_cast<int>(err);
}
