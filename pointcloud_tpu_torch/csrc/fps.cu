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
//   block   (N <= kMaxBlockPoints = 512 x 24): one thread block per cloud of
//           kThreads threads, each keeping kSlots points (x, y, z, mind) in
//           registers, point t * kThreads + threadIdx.x in slot t, so a
//           thread's points ascend in index; the cloud's coordinates also
//           sit in shared memory (12 bytes a point) for reading a winner
//           out. A step is: update mind and take the thread's argmax
//           (registers only, `thread_pass`), the warp's argmax left in every
//           lane (`warp_argmax`), lane 0 writes it to slot [s & 1][warp],
//           ONE __syncthreads, then every warp reduces the kWarps slots by
//           the same rule and reads the winner's coordinates. The slots are
//           double-buffered by step parity: a warp writes step s + 2's slot
//           only after step s + 1's barrier, which every warp reaches only
//           after reading step s's slots. Many clouds (PointNet2's B=256 x
//           2048) fill the card, one cloud (`encode`) runs on one SM. A
//           sibling of the cluster kernel rather than the cluster kernel at
//           a cluster of one: that one pays a block reduction (two
//           barriers) before its cluster barrier, which a lone block can
//           fold into the one barrier above.
//   cluster (N <= kClusterMax * kMaxBlockPoints = 196,608, the sensor's
//           single cloud): one cloud over a thread block cluster of up to
//           16 blocks (16 is a non-portable size), each on its own SM. Each
//           block owns a contiguous slice of at most 12,288 points and keeps
//           them in registers as the block route does (24 a thread, the
//           same `thread_pass` and `warp_argmax`), plus its slice's
//           coordinates in shared memory. A step is: the thread's and the
//           warp's argmax, the block's (one exchange through shared
//           memory), then warp 0 pushes the block's candidate (value,
//           index, x, y, z) into a slot of every block of the cluster
//           through distributed shared memory and all blocks meet at one
//           cluster barrier. Every block then reduces the candidates in
//           rank order with the same rule (larger value, else lower index),
//           so all agree on the winner and its coordinates without another
//           exchange. The slots are double-buffered by step parity as
//           above. Slot 0 (the first valid point) crosses blocks the same
//           way, on (valid ? 1 : 0, lowest valid index, else the block's
//           lowest index).
//   scratch (larger N): one block per cloud over a global scratch of
//           (x, y, z, mind) that stays in L2.
//
// Exactness: FPS is chaotic, so the distance is computed with rounded
// intrinsics in the TPU kernel's order, ((dx*dx + dy*dy) + dz*dz), with no
// FMA contraction; the plain version computes the same separate operations,
// and the two give equal indices. The register routes take fminf(mind, d)
// on every point, masked ones and padding slots (mind -1, losing every tie
// to a lower index) too: their -1 stays -1 (d >= 0), as the plain version's
// where() keeps it. The warp's argmax reduces (value, index) as one order:
// mind values are -1 or >= +0, whose bits order as unsigned integers, so a
// redux.sync max over the key (bits + 1, 0 for -1) and a redux.sync min of
// the index over the lanes holding that key give the largest value and its
// lowest index in every lane.
//
// Bound on the card: operations, about 9 per (step, point): B*(K-1)*N*9 fp32
// operations at the card's fp32 rate (0.054 ms for the sensor's 196,608
// points and K = 2048; 0.036 ms at PointNet2's SA1). What binds the routes
// is the K-1 serial reductions, i.e. a step's latency: on the block route
// one pass over kSlots registers (~12 instructions a point, independent
// across slots), two redux.sync pairs, one barrier and three dependent
// shared-memory reads; on the cluster route the same pass over 12,288
// points on each of 16 SMs, a block reduction (two barriers) and one
// cluster barrier, instead of one SM streaming the whole 3 MB working set
// from L2 every step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSlots = 24;  // points a thread keeps in registers
constexpr int kClusterThreads = 512;
constexpr int kMaxBlockPoints = kClusterThreads * kMaxSlots;  // 12,288
constexpr int kClusterMax = 16;                               // non-portable above 8
constexpr int kScratchThreads = 1024;
constexpr int kRouteBlock = 0, kRouteCluster = 1, kRouteScratch = 2;
constexpr int kBadArgs = static_cast<int>(cudaErrorInvalidValue);

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx,
                                         float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// ---- the register routes' shared steps ----

// A mind value (-1, or >= +0) as an unsigned key of the same order.
__device__ __forceinline__ unsigned order_key(float v) {
  return v >= 0.f ? __float_as_uint(v) + 1u : 0u;
}
__device__ __forceinline__ float key_value(unsigned key) {
  return key == 0u ? -1.f : __uint_as_float(key - 1u);
}

// (key, index) reduced over the warp to the largest key and, among the lanes
// holding it, the lowest index; every lane returns the result.
__device__ __forceinline__ void warp_argmax(unsigned& key, unsigned& idx) {
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == top ? idx : 0xffffffffu);
  key = top;
}

// One step of a thread over its kSlots points: mind = min(mind, d) against
// the last winner (lx, ly, lz), and the thread's argmax (value, slot), the
// lowest slot on ties: four chains over contiguous quarters of the slots,
// merged in slot order (a shorter dependent chain than one pass).
template <int kSlots>
__device__ __forceinline__ void thread_pass(const float (&px)[kSlots], const float (&py)[kSlots],
                                            const float (&pz)[kSlots], float (&pm)[kSlots],
                                            float lx, float ly, float lz, float& v, int& slot) {
  static_assert(kSlots % 4 == 0, "four chains of equal length");
  constexpr int kQ = kSlots / 4;
  float bv[4];
  int bt[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bv[g] = -INFINITY;
    bt[g] = g * kQ;
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int t = g * kQ + u;
      pm[t] = fminf(pm[t], sq_dist(px[t], py[t], pz[t], lx, ly, lz));
      if (pm[t] > bv[g]) {  // strict: the chain's lowest slot on ties
        bv[g] = pm[t];
        bt[g] = t;
      }
    }
  }
  // later chains hold higher slots: they win only with a larger value
  if (bv[1] > bv[0]) bv[0] = bv[1], bt[0] = bt[1];
  if (bv[3] > bv[2]) bv[2] = bv[3], bt[2] = bt[3];
  if (bv[2] > bv[0]) bv[0] = bv[2], bt[0] = bt[2];
  v = bv[0];
  slot = bt[0];
}

// ---- block route ----

// The block's argmax of the threads' (key, idx), in every thread: the warps'
// results through slot[warp], one barrier, then every warp reduces them in
// the same way (lanes past the warps hold key 0 and the largest index).
template <int kWarps>
__device__ __forceinline__ unsigned block_argmax(unsigned key, unsigned idx, uint2* slot) {
  warp_argmax(key, idx);
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = make_uint2(key, idx);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  uint2 s = lane < kWarps ? slot[lane] : make_uint2(0u, 0xffffffffu);
  warp_argmax(s.x, s.y);
  return s.y;
}

template <int kThreads, int kSlots>
__global__ void __launch_bounds__(kThreads)
    fps_block_kernel(const float* __restrict__ xyz, int c, const uint8_t* __restrict__ mask,
                     int n, int k, int* __restrict__ out) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float cloud[];  // xs, ys, zs: n floats each
  __shared__ uint2 slots[2][kWarps];  // (key, index) of each warp, by step parity

  const int64_t b = blockIdx.x;
  const float* xb = xyz + b * n * static_cast<int64_t>(c);
  const uint8_t* mb = mask != nullptr ? mask + b * n : nullptr;
  int* ob = out + b * k;
  float* xs = cloud;
  float* ys = cloud + n;
  float* zs = cloud + 2 * n;

  float px[kSlots], py[kSlots], pz[kSlots], pm[kSlots];
  bool any_valid = false;
  int first = threadIdx.x;  // no valid point: this thread's lowest index
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int i = t * kThreads + threadIdx.x;
    float x = 0.f, y = 0.f, z = 0.f;
    bool valid = false;
    if (i < n) {
      const float* p = xb + static_cast<int64_t>(i) * c;
      x = p[0];
      y = p[1];
      z = p[2];
      xs[i] = x;
      ys[i] = y;
      zs[i] = z;
      valid = mb == nullptr || mb[i] != 0;
    }
    px[t] = x;
    py[t] = y;
    pz[t] = z;
    pm[t] = valid ? 1e10f : -1.f;  // padding slots: -1, past every real point
    if (valid && !any_valid) {
      any_valid = true;
      first = i;
    }
  }

  // (1, first) beats every (0, .): the lowest valid index, else 0
  int last = static_cast<int>(block_argmax<kWarps>(order_key(any_valid ? 1.f : 0.f),
                                                   static_cast<unsigned>(first), slots[0]));
  if (threadIdx.x == 0) ob[0] = last;

  for (int s = 1; s < k; ++s) {
    const float lx = xs[last], ly = ys[last], lz = zs[last];
    float v;
    int slot;
    thread_pass<kSlots>(px, py, pz, pm, lx, ly, lz, v, slot);
    last = static_cast<int>(block_argmax<kWarps>(
        order_key(v), static_cast<unsigned>(slot * kThreads + threadIdx.x), slots[s & 1]));
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

// The cluster's argmax of the threads' (key, idx) and the winner's
// coordinates: the block's argmax, pushed by warp 0 into slot `rank` of every
// block's slots[par], one cluster barrier, then every thread reduces the cl
// slots in rank order. xs, ys, zs: this block's slice (local index i - base).
__device__ __forceinline__ Candidate cluster_argmax(
    cg::cluster_group& cluster, unsigned key, unsigned idx, uint2* warp_best,
    Candidate (*slots)[kClusterMax], int par, int rank, int cl, int base,
    const float* xs, const float* ys, const float* zs) {
  constexpr int kWarps = kClusterThreads / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  warp_argmax(key, idx);
  if (lane == 0) warp_best[warp] = make_uint2(key, idx);
  __syncthreads();
  if (warp == 0) {
    uint2 s = lane < kWarps ? warp_best[lane] : make_uint2(0u, 0xffffffffu);
    warp_argmax(s.x, s.y);
    if (lane < cl) {
      // the block's winner is one of its own points: padding slots lose
      // every tie to the block's first point, which exists
      const int li = static_cast<int>(s.y) - base;
      const float4 lo = make_float4(key_value(s.x), __int_as_float(static_cast<int>(s.y)),
                                    xs[li], ys[li]);
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
  __shared__ uint2 warp_best[32];

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
  float px[kMaxSlots], py[kMaxSlots], pz[kMaxSlots], pm[kMaxSlots];
  bool any_valid = false;
  int first = base + threadIdx.x;  // no valid point: this thread's lowest
#pragma unroll
  for (int t = 0; t < kMaxSlots; ++t) {
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
  Candidate w = cluster_argmax(cluster, order_key(any_valid ? 1.f : 0.f),
                               static_cast<unsigned>(first), warp_best, slots, 0, rank, cl,
                               base, xs, ys, zs);
  if (rank == 0 && threadIdx.x == 0) ob[0] = w.i;

  for (int s = 1; s < k; ++s) {
    float v;
    int slot;
    thread_pass<kMaxSlots>(px, py, pz, pm, w.x, w.y, w.z, v, slot);
    w = cluster_argmax(cluster, order_key(v),
                       static_cast<unsigned>(base + slot * kClusterThreads + threadIdx.x),
                       warp_best, slots, s & 1, rank, cl, base, xs, ys, zs);
    if (rank == 0 && threadIdx.x == 0) ob[s] = w.i;
  }
}

// ---- scratch route ----

// Block-wide argmax on (v, i), lowest i on ties; every thread returns it.
template <int kThreads>
__device__ __forceinline__ int scratch_argmax(float v, int i, float* warp_v, int* warp_i,
                                              int* winner) {
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

__global__ void __launch_bounds__(kScratchThreads)
    fps_scratch_kernel(const float* __restrict__ xyz, int c,
                       const uint8_t* __restrict__ mask, int n, int k,
                       float4* __restrict__ work, int* __restrict__ out) {
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  __shared__ int winner;

  const int64_t b = blockIdx.x;
  float4* pts = work + b * n;
  const float* xb = xyz + b * n * static_cast<int64_t>(c);
  const uint8_t* mb = mask != nullptr ? mask + b * n : nullptr;
  int* ob = out + b * k;

  // stage the cloud; the first valid index of this thread's points
  bool any_valid = false;
  int first = 0;
  for (int i = threadIdx.x; i < n; i += kScratchThreads) {
    const bool valid = mb == nullptr || mb[i] != 0;
    const float* p = xb + static_cast<int64_t>(i) * c;
    pts[i] = make_float4(p[0], p[1], p[2], valid ? 1e10f : -1.f);
    if (valid && !any_valid) {
      any_valid = true;
      first = i;
    }
  }
  // (1, first) beats every (0, 0): the lowest valid index, else 0
  int last = scratch_argmax<kScratchThreads>(any_valid ? 1.f : 0.f, first, warp_v, warp_i,
                                             &winner);
  if (threadIdx.x == 0) ob[0] = last;

  for (int s = 1; s < k; ++s) {
    const float lx = pts[last].x;
    const float ly = pts[last].y;
    const float lz = pts[last].z;
    float best_v = -INFINITY;
    int best_i = INT_MAX;
    for (int i = threadIdx.x; i < n; i += kScratchThreads) {
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
    last = scratch_argmax<kScratchThreads>(best_v, best_i, warp_v, warp_i, &winner);
    if (threadIdx.x == 0) ob[s] = last;
  }
}

template <int kThreads, int kSlots>
cudaError_t launch_block(const float* xyz, int c, const uint8_t* mask, int b, int n, int k,
                         int* out, cudaStream_t stream) {
  // the dynamic share and the static slots together may pass 48 KB
  const size_t smem = static_cast<size_t>(n) * 3 * sizeof(float);
  const cudaError_t err = hopper::allow_all_smem<fps_block_kernel<kThreads, kSlots>>();
  if (err != cudaSuccess) return err;
  fps_block_kernel<kThreads, kSlots><<<b, kThreads, smem, stream>>>(xyz, c, mask, n, k, out);
  return cudaGetLastError();
}

template <int kThreads>
cudaError_t launch_block_slots(const float* xyz, int c, const uint8_t* mask, int b, int n,
                               int k, int slots, int* out, cudaStream_t stream) {
  switch (slots) {
    case 4:
      return launch_block<kThreads, 4>(xyz, c, mask, b, n, k, out, stream);
    case 8:
      return launch_block<kThreads, 8>(xyz, c, mask, b, n, k, out, stream);
    case 12:
      return launch_block<kThreads, 12>(xyz, c, mask, b, n, k, out, stream);
    case 16:
      return launch_block<kThreads, 16>(xyz, c, mask, b, n, k, out, stream);
    case 20:
      return launch_block<kThreads, 20>(xyz, c, mask, b, n, k, out, stream);
    case 24:
      return launch_block<kThreads, 24>(xyz, c, mask, b, n, k, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_cluster(const float* xyz, int c, const uint8_t* mask, int b,
                           int n, int k, int cl, int per_block, int* out,
                           cudaStream_t stream) {
  const int smem = 3 * per_block * static_cast<int>(sizeof(float));
  cudaError_t err = hopper::allow_all_smem<fps_cluster_kernel>();
  if (err != cudaSuccess) return err;
  if (cl > 8) {
    err = cudaFuncSetAttribute(fps_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
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
//   0 block:   threads 64, 128, 256 or 512 of slots 4, 8, ..., 24 points
//              each, N <= threads x slots (cl, per_block unused);
//   1 cluster: cl blocks of 512 threads x 24 slots a cloud (2 <= cl <= 16),
//              per_block points a block (<= 12,288), (cl - 1) per_block <
//              N <= cl per_block;
//   2 scratch: 1024 threads, work (B, 4N) f32 in device memory.
// Returns the CUDA error of the launch (0 on success; cudaErrorInvalidValue
// for a geometry the route does not take).
extern "C" int fps_launch(const float* xyz, int c, const uint8_t* mask, int b, int n, int k,
                          int route, int threads, int slots, int cl, int per_block,
                          float* work, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || n < 1 || k < 1 || c < 3) return kBadArgs;
  cudaError_t err;
  if (route == kRouteBlock) {
    if (n > threads * slots) return kBadArgs;
    switch (threads) {
      case 64:
        err = launch_block_slots<64>(xyz, c, mask, b, n, k, slots, out, s);
        break;
      case 128:
        err = launch_block_slots<128>(xyz, c, mask, b, n, k, slots, out, s);
        break;
      case 256:
        err = launch_block_slots<256>(xyz, c, mask, b, n, k, slots, out, s);
        break;
      case 512:
        err = launch_block_slots<512>(xyz, c, mask, b, n, k, slots, out, s);
        break;
      default:
        return kBadArgs;
    }
  } else if (route == kRouteCluster) {
    if (threads != kClusterThreads || slots != kMaxSlots || cl < 2 || cl > kClusterMax ||
        per_block < 1 || per_block > kMaxBlockPoints ||
        static_cast<int64_t>(cl) * per_block < n ||
        static_cast<int64_t>(cl - 1) * per_block >= n)
      return kBadArgs;
    err = launch_cluster(xyz, c, mask, b, n, k, cl, per_block, out, s);
  } else if (route == kRouteScratch) {
    if (work == nullptr || threads != kScratchThreads) return kBadArgs;
    fps_scratch_kernel<<<b, kScratchThreads, 0, s>>>(xyz, c, mask, n, k,
                                                     reinterpret_cast<float4*>(work), out);
    err = cudaGetLastError();
  } else {
    return kBadArgs;
  }
  return static_cast<int>(err);
}
