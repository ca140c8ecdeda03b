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
// The K steps are sequential: each needs the point the last one chose. Three
// routes, picked from (B, N) by the caller's plan (ops/fps.py fps_plan):
//   block   (N <= kMaxSharedPoints): one thread block per cloud keeps (x, y,
//           z, mind) of every point in shared memory. Each step updates mind
//           over the block's points, takes a block-wide argmax on (value,
//           index) with warp shuffles and one exchange through shared
//           memory, and reads the winner back as the next step's centre.
//           Many clouds (PointNet2's B=256 x 2048) fill the card this way.
//   cluster (N <= kClusterMax * kBlockPoints = 196,608, the sensor's single
//           cloud): one cloud over a thread block cluster of up to 16 blocks
//           (16 is a non-portable size), each on its own SM. Each block owns
//           a contiguous slice of at most kBlockPoints points and keeps
//           (x, y, z, mind) of them in registers, kSlots points a thread,
//           plus its slice's coordinates in shared memory for reading out a
//           winner. A step is: update mind and take the thread's argmax
//           (registers only), the block's argmax (shuffles, one exchange
//           through shared memory), then warp 0 pushes the block's
//           candidate (value, index, x, y, z) into a slot of every block of
//           the cluster through distributed shared memory and all blocks
//           meet at one cluster barrier. Every block then reduces the
//           candidates in rank order with the same rule (larger value, else
//           lower index), so all agree on the winner and its coordinates
//           without another exchange. The slots are double-buffered by step
//           parity: a block can write step s + 2's candidate only after
//           every block has passed step s + 1's barrier, which each reaches
//           only after reading step s's slots, so one barrier a step
//           suffices. Slot 0 (the first valid point) crosses blocks the same
//           way, on (valid ? 1 : 0, lowest valid index, else the block's
//           lowest index).
//   scratch (larger N): one block per cloud over a global scratch of
//           (x, y, z, mind) that stays in L2.
//
// Exactness: FPS is chaotic, so the distance is computed with rounded
// intrinsics in the TPU kernel's order, ((dx*dx + dy*dy) + dz*dz), with no
// FMA contraction; the plain version computes the same separate operations,
// and the two give equal indices. The cluster route takes fminf(mind, d) on
// every point, masked ones too: their -1 stays -1 (d >= 0), as the plain
// version's where() keeps it.
//
// Bound on the card: operations, about 9 per (step, point): B*(K-1)*N*9 fp32
// operations at the card's fp32 rate (0.054 ms for the sensor's 196,608
// points and K = 2048). What binds the routes is the K-1 serial reductions:
// the cluster route pays per step one pass over 12,288 points in registers
// on each of 16 SMs (~12 instructions a point, ~0.6 us), a block reduction
// (two barriers) and one cluster barrier, instead of one SM streaming the
// whole 3 MB working set from L2 every step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSharedPoints = 12288;  // block route: 192 KB of (x, y, z, mind)
constexpr int kClusterThreads = 512;
constexpr int kSlots = 24;  // points a cluster-route thread keeps in registers
constexpr int kBlockPoints = kClusterThreads * kSlots;  // 12,288
constexpr int kClusterMax = 16;                         // non-portable above 8
constexpr int kRouteBlock = 0, kRouteCluster = 1, kRouteScratch = 2;
constexpr int kBadArgs = static_cast<int>(cudaErrorInvalidValue);

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

__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx,
                                         float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
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
        m = fminf(m, sq_dist(pts[i].x, pts[i].y, pts[i].z, lx, ly, lz));
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

// ---- cluster route ----

struct Candidate {  // one block's argmax and its point, as every block reads it
  float v;
  int i;
  float x, y, z;
  float pad[3];
};

// (v, i) reduced over the warp; every lane returns the result (butterfly in
// a fixed pattern, so the result does not depend on timing).
__device__ __forceinline__ void warp_argmax_all(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    take_better(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                __shfl_xor_sync(0xffffffffu, i, off));
  }
}

// The cluster's argmax of the threads' (v, i) and the winner's coordinates:
// the block's argmax, pushed by warp 0 into slot `rank` of every block's
// slots[par], one cluster barrier, then every thread reduces the cl slots
// in rank order. xs, ys, zs: this block's slice (local index i - base).
__device__ __forceinline__ Candidate cluster_argmax(
    cg::cluster_group& cluster, float v, int i, float* warp_v, int* warp_i,
    Candidate (*slots)[kClusterMax], int par, int rank, int cl, int base,
    const float* xs, const float* ys, const float* zs) {
  constexpr int kWarps = kClusterThreads / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  warp_argmax_all(v, i);
  if (lane == 0) {
    warp_v[warp] = v;
    warp_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_v[lane] : -INFINITY;
    i = lane < kWarps ? warp_i[lane] : INT_MAX;
    warp_argmax_all(v, i);
    if (lane < cl) {
      // the block's winner is one of its own points: padding slots lose
      // every tie to the block's first point, which exists
      const int li = i - base;
      const float4 lo = make_float4(v, __int_as_float(i), xs[li], ys[li]);
      const float4 hi = make_float4(zs[li], 0.f, 0.f, 0.f);
      float4* dst = reinterpret_cast<float4*>(
          cluster.map_shared_rank(&slots[par][rank], lane));
      dst[0] = lo;
      dst[1] = hi;
    }
  }
  cluster.sync();  // release the pushes, acquire every block's
  const Candidate* cand = slots[par];
  int best = 0;
  float bv = cand[0].v;
  int bi = cand[0].i;
  for (int r = 1; r < cl; ++r) {
    const float ov = cand[r].v;
    const int oi = cand[r].i;
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
      best = r;
    }
  }
  return cand[best];
}

__global__ void __launch_bounds__(kClusterThreads, 1)
    fps_cluster_kernel(const float* __restrict__ xyz, int c,
                       const uint8_t* __restrict__ mask, int n, int k,
                       int per_block, int* __restrict__ out) {
  extern __shared__ float slice[];  // xs, ys, zs: per_block floats each
  __shared__ __align__(16) Candidate slots[2][kClusterMax];
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = static_cast<int>(cluster.num_blocks());
  const int64_t b = blockIdx.x / cl;
  const float* xb = xyz + b * n * static_cast<int64_t>(c);
  const uint8_t* mb = mask != nullptr ? mask + b * n : nullptr;
  int* ob = out + b * k;
  float* xs = slice;
  float* ys = slice + per_block;
  float* zs = slice + 2 * per_block;
  const int base = rank * per_block;
  const int count = min(per_block, n - base);  // >= 1: the plan's geometry

  // this thread's points base + t * kClusterThreads + threadIdx.x, in
  // increasing index; padding slots (past the slice) hold mind -1 and lose
  // every tie to a lower index
  float px[kSlots], py[kSlots], pz[kSlots], pm[kSlots];
  bool any_valid = false;
  int first = base + threadIdx.x;  // no valid point: this thread's lowest
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int li = t * kClusterThreads + threadIdx.x;
    const int gi = base + li;
    float x = 0.f, y = 0.f, z = 0.f;
    bool valid = false;
    if (li < count) {
      const float* p = xb + static_cast<int64_t>(gi) * c;
      x = p[0];
      y = p[1];
      z = p[2];
      xs[li] = x;
      ys[li] = y;
      zs[li] = z;
      valid = mb == nullptr || mb[gi] != 0;
    }
    px[t] = x;
    py[t] = y;
    pz[t] = z;
    pm[t] = valid ? 1e10f : -1.f;
    if (valid && !any_valid) {
      any_valid = true;
      first = gi;
    }
  }
  cluster.sync();  // every block has started: its slots may be written

  // (1, lowest valid index) beats every (0, .); with no valid point anywhere
  // (0, 0) wins: block 0's lowest index
  Candidate w = cluster_argmax(cluster, any_valid ? 1.f : 0.f, first, warp_v, warp_i,
                               slots, 0, rank, cl, base, xs, ys, zs);
  if (rank == 0 && threadIdx.x == 0) ob[0] = w.i;

  for (int s = 1; s < k; ++s) {
    const float lx = w.x, ly = w.y, lz = w.z;
    float best_v = -INFINITY;
    int best_t = 0;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      pm[t] = fminf(pm[t], sq_dist(px[t], py[t], pz[t], lx, ly, lz));
      if (pm[t] > best_v) {  // strict: this thread's lowest index on ties
        best_v = pm[t];
        best_t = t;
      }
    }
    w = cluster_argmax(cluster, best_v, base + best_t * kClusterThreads + threadIdx.x,
                       warp_v, warp_i, slots, s & 1, rank, cl, base, xs, ys, zs);
    if (rank == 0 && threadIdx.x == 0) ob[s] = w.i;
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

cudaError_t launch_cluster(const float* xyz, int c, const uint8_t* mask, int b,
                           int n, int k, int cl, int per_block, int* out,
                           cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&fps_cluster_kernel);
  const int smem = 3 * per_block * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (cl > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * static_cast<unsigned>(cl));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cl);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, xyz, c, mask, n, k, per_block, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// xyz (B, N, C) f32, mask (B, N) bool or null, out (B, K) i32. route and
// its geometry come from ops/fps.py fps_plan:
//   0 block:   N <= 12,288, threads 256 or 1024 (cl, per_block unused);
//   1 cluster: cl blocks of 512 threads a cloud (2 <= cl <= 16), per_block
//              points a block (<= 12,288), (cl - 1) per_block < N <=
//              cl per_block;
//   2 scratch: work (B, 4N) f32 in device memory.
// Returns the CUDA error of the launch (0 on success; cudaErrorInvalidValue
// for a geometry the route does not take).
extern "C" int fps_launch(const float* xyz, int c, const uint8_t* mask, int b,
                          int n, int k, int route, int threads, int cl,
                          int per_block, float* work, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || n < 1 || k < 1 || c < 3) return kBadArgs;
  cudaError_t err;
  if (route == kRouteBlock) {
    if (n > kMaxSharedPoints) return kBadArgs;
    if (threads == 1024) {
      err = launch<true, 1024>(xyz, c, mask, b, n, k, nullptr, out, s);
    } else if (threads == 256) {
      err = launch<true, 256>(xyz, c, mask, b, n, k, nullptr, out, s);
    } else {
      return kBadArgs;
    }
  } else if (route == kRouteCluster) {
    if (threads != kClusterThreads || cl < 2 || cl > kClusterMax || per_block < 1 ||
        per_block > kBlockPoints || static_cast<int64_t>(cl) * per_block < n ||
        static_cast<int64_t>(cl - 1) * per_block >= n)
      return kBadArgs;
    err = launch_cluster(xyz, c, mask, b, n, k, cl, per_block, out, s);
  } else if (route == kRouteScratch) {
    if (work == nullptr || threads != 1024) return kBadArgs;
    err = launch<false, 1024>(xyz, c, mask, b, n, k, reinterpret_cast<float4*>(work),
                              out, s);
  } else {
    return kBadArgs;
  }
  return static_cast<int>(err);
}
