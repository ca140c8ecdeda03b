// Exact kNN grouping with the row gather (sm_90a).
//
// Replaces pointcloud_tpu/ops/pallas_kernels.py:_group_knn_smajor_kernel
// (reached through _gg_knn_call by grouped_gather_knn and
// grouped_gather_knn_feats). For clouds xyz (B, N, 3) fp32, features
// (B, N, F) fp32 or bf16 (or none, F = 0), centroids (B, S, 3) fp32 and an
// optional validity mask (B, N), writes
//   idx (B, S, k) int32: the k nearest points of each centroid in distance
//     order, the lowest index first on ties; slots past the valid count
//     repeat slot 0;
//   grouped_feats (B, S, k, F) in the features' dtype, copied bit for bit;
//   grouped_xyz (B, S, k, 3) fp32, not centred (optional).
// The distance is ((pen + dx^2) + dy^2) + dz^2 on direct differences d =
// centroid - point, pen = 1e9 on masked points and 0 elsewhere, with rounded
// intrinsics so that nvcc contracts no FMA: the TPU kernel's formula and
// order. The valid count is the number of points with d < 0.5e9. With no
// valid point, slot 0 is the point of least penalised distance (1e9 + d
// rounds to a 64-wide grid, so at unit scale that is point 0) and every slot
// repeats it, as in the TPU kernel.
//
// Design: one warp per centroid, 8 warps a block, each warp walking a few
// centroids of one cloud. A cloud of up to kMaxSharedPoints points is staged
// in shared memory as four arrays (x, y, z, pen); a larger one is read from
// global memory. Lane l owns the contiguous chunk of c = ceil(N / 32) points
// from l * c, stored at a stride of c | 1 so that the lanes' chunk walks hit
// distinct banks. The selection orders points by the 64-bit key (distance
// bits, index), which is the TPU kernel's (min distance, lowest index) order
// because distances are never negative. Each lane first finds the least key
// of its chunk (one distance per point, N per centroid in all). Each of the
// min(k, valid count) rounds then takes the warp-wide least key as the next
// slot, and the whole warp rescans only the winner's chunk for its least key
// above the winner: every key below it is taken already, so no point needs
// a mark. A round costs two 5-step shuffle reductions and c / 32 distances a
// lane, where the TPU kernel sweeps all N points k times. The warp then
// writes its k output rows as one contiguous run, lanes on consecutive
// 16-byte words when the row width allows it, else on consecutive elements.
//
// Bound on the card: bytes. The gathered rows (B*S*k*F elements) are the bulk
// of the traffic; the ~10 fp32 operations per (centroid, point) of the
// distance pass are below the card's fp32 rate at every shape of the path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPen = 1e9f;
constexpr float kValidBelow = 0.5e9f;
constexpr int kMaxSharedBytes = 160 * 1024;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ float pen_dist(float cx, float cy, float cz,
                                          float px, float py, float pz,
                                          float pen) {
  const float dx = __fsub_rn(cx, px);
  const float dy = __fsub_rn(cy, py);
  const float dz = __fsub_rn(cz, pz);
  float acc = __fadd_rn(pen, __fmul_rn(dx, dx));
  acc = __fadd_rn(acc, __fmul_rn(dy, dy));
  return __fadd_rn(acc, __fmul_rn(dz, dz));
}

// (distance, index) as one key: non-negative floats order as their bits
__device__ __forceinline__ unsigned long long make_key(float d, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned>(i);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// The points of one cloud: shared-memory arrays at the padded chunk stride,
// or the global tensors.
struct Cloud {
  const float* sx = nullptr;
  const float* sy = nullptr;
  const float* sz = nullptr;
  const float* spen = nullptr;
  const float* xyz = nullptr;     // global (N, 3) of this cloud
  const uint8_t* mask = nullptr;  // global (N) of this cloud or null
  int c = 0;                      // chunk length
  int cp = 0;                     // padded chunk stride

  template <bool kShared>
  __device__ __forceinline__ float dist(int chunk, int t, float cx, float cy,
                                        float cz) const {
    if (kShared) {
      const int s = chunk * cp + t;
      return pen_dist(cx, cy, cz, sx[s], sy[s], sz[s], spen[s]);
    }
    const int64_t i = static_cast<int64_t>(chunk) * c + t;
    const float pen = (mask == nullptr || mask[i] != 0) ? 0.f : kPen;
    return pen_dist(cx, cy, cz, xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2],
                    pen);
  }
};

// Copy k rows of `width` units (T: 4 or 2 bytes, or uint4) from src rows
// slots[j] to the contiguous dst, lanes on consecutive units.
template <typename T>
__device__ __forceinline__ void gather_rows(const T* __restrict__ src,
                                            T* __restrict__ dst,
                                            const int* slots, int k,
                                            int width, int lane) {
  const int total = k * width;
  for (int e = lane; e < total; e += 32) {
    const int j = e / width;
    const int u = e - j * width;
    dst[e] = src[static_cast<int64_t>(slots[j]) * width + u];
  }
}

template <bool kShared, typename T>
__global__ void __launch_bounds__(kThreads)
    knn_group_kernel(const float* __restrict__ xyz, const void* feats,
                     const float* __restrict__ cents,
                     const uint8_t* __restrict__ mask, int n, int s_count,
                     int k, int f, int vec, int* idx, float* __restrict__ gx,
                     void* gf) {
  extern __shared__ float shared[];
  const int64_t b = blockIdx.y;
  const int c = (n + 31) / 32;
  Cloud cloud;
  cloud.c = c;
  cloud.cp = c | 1;
  cloud.xyz = xyz + b * n * 3;
  cloud.mask = mask != nullptr ? mask + b * n : nullptr;
  if (kShared) {
    const int len = 32 * cloud.cp;
    float* sx = shared;
    float* sy = sx + len;
    float* sz = sy + len;
    float* spen = sz + len;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int chunk = i / c;
      const int s = chunk * cloud.cp + (i - chunk * c);
      sx[s] = cloud.xyz[3 * static_cast<int64_t>(i)];
      sy[s] = cloud.xyz[3 * static_cast<int64_t>(i) + 1];
      sz[s] = cloud.xyz[3 * static_cast<int64_t>(i) + 2];
      spen[s] = (cloud.mask == nullptr || cloud.mask[i] != 0) ? 0.f : kPen;
    }
    cloud.sx = sx;
    cloud.sy = sy;
    cloud.sz = sz;
    cloud.spen = spen;
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = lane * c;  // this lane's chunk: [first, first + c)

  for (int s = blockIdx.x * kWarps + warp; s < s_count;
       s += gridDim.x * kWarps) {  // no block-wide barrier follows
    const int64_t row = b * s_count + s;
    const float cx = cents[3 * row];
    const float cy = cents[3 * row + 1];
    const float cz = cents[3 * row + 2];

    unsigned long long best = kNone;
    int valid = 0;
    for (int t = 0; t < c && first + t < n; ++t) {
      const float d = cloud.dist<kShared>(lane, t, cx, cy, cz);
      valid += d < kValidBelow;
      const unsigned long long key = make_key(d, first + t);
      best = key < best ? key : best;
    }
    const int count = __reduce_add_sync(kFull, valid);
    const int rounds = max(1, min(k, count));

    int* slots = idx + row * k;  // read back by every lane after __syncwarp
    for (int j = 0; j < rounds; ++j) {
      const unsigned long long win = warp_min(best);
      const int wi = static_cast<int>(win & 0xffffffffu);
      if (lane == 0) slots[j] = wi;
      if (j + 1 == rounds) break;
      // the winner's chunk, rescanned by the whole warp: its least key above
      // the winner is its next candidate
      const int owner = wi / c;
      unsigned long long next = kNone;
      for (int t = lane; t < c && owner * c + t < n; t += 32) {
        const float d = cloud.dist<kShared>(owner, t, cx, cy, cz);
        const unsigned long long key = make_key(d, owner * c + t);
        if (key > win && key < next) next = key;
      }
      next = warp_min(next);
      if (lane == owner) best = next;
    }
    __syncwarp();
    const int slot0 = slots[0];
    for (int j = rounds + lane; j < k; j += 32) slots[j] = slot0;
    __syncwarp();

    if (gx != nullptr) {
      gather_rows<float>(cloud.xyz, gx + row * k * 3, slots, k, 3, lane);
    }
    if (f > 0) {
      const int64_t esize = sizeof(T);
      const char* fb = static_cast<const char*>(feats) + b * n * f * esize;
      char* ob = static_cast<char*>(gf) + row * k * f * esize;
      if (vec) {
        const int units = static_cast<int>(f * esize / 16);
        gather_rows<uint4>(reinterpret_cast<const uint4*>(fb),
                           reinterpret_cast<uint4*>(ob), slots, k, units, lane);
      } else {
        gather_rows<T>(reinterpret_cast<const T*>(fb), reinterpret_cast<T*>(ob),
                       slots, k, f, lane);
      }
    }
    __syncwarp();  // the slots of this centroid are read before the next's
  }
}

template <bool kShared, typename T>
cudaError_t launch(const float* xyz, const void* feats, const float* cents,
                   const uint8_t* mask, int b, int n, int s_count, int k, int f,
                   int vec, int* idx, float* gx, void* gf, size_t smem,
                   int blocks_x, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_group_kernel<kShared, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(blocks_x, b);
  knn_group_kernel<kShared, T><<<grid, kThreads, smem, stream>>>(
      xyz, feats, cents, mask, n, s_count, k, f, vec, idx, gx, gf);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// xyz (B, N, 3) f32, feats (B, N, F) of esize-byte elements (4: fp32, 2:
// bf16) or null with F = 0, cents (B, S, 3) f32, mask (B, N) bool or null;
// idx (B, S, k) i32, gx (B, S, k, 3) f32 or null, gf (B, S, k, F) like
// feats or null with F = 0. vec != 0 lets the gather move 16-byte words (the
// caller checked that F * esize is a multiple of 16 and both feature
// pointers 16-byte aligned). Returns the CUDA error of the launch (0 on
// success); the caller checked the bounds (1 <= B <= 65535, N >= 1, k >= 1).
extern "C" int knn_group_launch(const float* xyz, const void* feats, int esize,
                                const float* cents, const uint8_t* mask, int b,
                                int n, int s_count, int k, int f, int vec,
                                int* idx, float* gx, void* gf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = (n + 31) / 32;
  const size_t smem = static_cast<size_t>(4) * 32 * (c | 1) * sizeof(float);
  const bool shared = smem <= kMaxSharedBytes;
  // a few centroids a warp where the batch gives blocks enough to fill the
  // card, so that a block stages its cloud once for several of them
  int per_warp = 1;
  while (per_warp < 8 &&
         static_cast<int64_t>(b) *
                 ((s_count + 2 * per_warp * kWarps - 1) / (2 * per_warp * kWarps)) >=
             1056) {
    per_warp *= 2;
  }
  const int blocks_x = (s_count + per_warp * kWarps - 1) / (per_warp * kWarps);
  cudaError_t err;
  if (esize == 2) {
    err = shared ? launch<true, uint16_t>(xyz, feats, cents, mask, b, n,
                                          s_count, k, f, vec, idx, gx, gf,
                                          smem, blocks_x, st)
                 : launch<false, uint16_t>(xyz, feats, cents, mask, b, n,
                                           s_count, k, f, vec, idx, gx, gf, 0,
                                           blocks_x, st);
  } else {
    err = shared ? launch<true, uint32_t>(xyz, feats, cents, mask, b, n,
                                          s_count, k, f, vec, idx, gx, gf,
                                          smem, blocks_x, st)
                 : launch<false, uint32_t>(xyz, feats, cents, mask, b, n,
                                           s_count, k, f, vec, idx, gx, gf, 0,
                                           blocks_x, st);
  }
  return static_cast<int>(err);
}
