// Ball query + uncentred gather in group_neighbors' public layout (sm_90a).
//
// Replaces the ball mode of pointcloud_tpu/ops/pallas_kernels.py:_group_kernel
// (reached through _group_gather_call and grouped_gather, the legacy grouping
// that the multi-scale-grouping set abstraction calls through
// group_neighbors). For clouds xyz (B, N, 3) fp32, features (B, N, F) of any
// element type (or none, F = 0), centroids (B, S, 3) fp32 and an optional
// validity mask (B, N), writes
//   gxyz (B, S, k, 3) fp32: xyz[idx], not centred (skipped when null);
//   gfeat (B, S, k, F): feats[idx], copied bit for bit (skipped when F = 0);
//   idx (B, S, k) int32: the first k points inside the ball in index order,
//     slots past the in-ball count repeating slot 0 (point 0 when the ball
//     is empty);
//   valid (B, S, k) bool: slot j < in-ball count.
// Membership and selection are ball_select.cuh's, shared with ball_group.cu:
// a point is inside when ((pen + dx^2) + dy^2) + dz^2 <= r2, the TPU kernel's
// formula and order in rounded intrinsics.
//
// Design: one warp per centroid, 16 centroids of one cloud per block, the
// cloud staged in shared memory up to kMaxSharedPoints points (read from
// global memory above). The warp selects with ball_select::select_first_k,
// then writes its k xyz rows as one contiguous run of 3k floats and its k
// feature rows as one contiguous run, lanes on consecutive words. The
// features are moved as raw words of W bytes (2, 4, 8 or 16: the widest that
// divides the row's bytes and both base addresses, chosen by the caller), so
// a 640-byte bf16 row of 320 channels goes as 40 16-byte words. Not carried
// over from the TPU: centroids on lanes, the prefix-count matrix product,
// one one-hot MXU dot per slot and the split-bf16 hi/lo channels of xyz and
// of the index (xyz is gathered exactly; any k >= 1 and any N).
//
// Bound on the card: bytes. The gathered rows are the bulk of the traffic
// (B*S*k*(12 + F*esize + 5) bytes written once); the distance tests, ~9
// operations a point up to the k-th in-ball point, are far below the card's
// fp32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ball_select.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
using ball_select::kMaxSharedPoints;

template <typename W, bool kShared>
__global__ void __launch_bounds__(kThreads)
    group_gather_kernel(const float* __restrict__ xyz, const W* __restrict__ feats,
                        const float* __restrict__ cents,
                        const uint8_t* __restrict__ mask, int n, int s_count,
                        int k, int words, float r2, float* __restrict__ gxyz,
                        W* __restrict__ gfeat, int* idx,
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

  if (gxyz != nullptr) {  // k rows of 3 floats, element e = 3 j + ch
    float* ob = gxyz + row * k * 3;
    for (int e = lane; e < 3 * k; e += 32) {
      const int j = e / 3;
      const int ch = e - 3 * j;
      const int p = slots[j];
      ob[e] = kShared ? (ch == 0 ? shared_points[p].x
                         : ch == 1 ? shared_points[p].y
                                   : shared_points[p].z)
                      : xb[3 * static_cast<int64_t>(p) + ch];
    }
  }
  if (words > 0) {  // k rows of `words` words, element e = j * words + w
    const int64_t total = static_cast<int64_t>(k) * words;
    W* ob = gfeat + row * total;
    const W* fb = feats + b * n * static_cast<int64_t>(words);
    const int dj = 32 / words;
    const int dw = 32 - dj * words;
    int j = lane / words;
    int w = lane - j * words;
    for (int64_t e = lane; e < total; e += 32) {
      ob[e] = fb[static_cast<int64_t>(slots[j]) * words + w];
      j += dj;
      w += dw;
      if (w >= words) {
        w -= words;
        ++j;
      }
    }
  }
}

template <typename W>
cudaError_t launch(const float* xyz, const void* feats, const float* cents,
                   const uint8_t* mask, int b, int n, int s_count, int k,
                   int words, float r2, float* gxyz, void* gfeat, int* idx,
                   bool* valid, cudaStream_t stream) {
  const dim3 grid((s_count + kWarps - 1) / kWarps, b);
  const W* fp = static_cast<const W*>(feats);
  W* op = static_cast<W*>(gfeat);
  if (n <= kMaxSharedPoints) {
    group_gather_kernel<W, true><<<grid, kThreads, 0, stream>>>(
        xyz, fp, cents, mask, n, s_count, k, words, r2, gxyz, op, idx, valid);
  } else {
    group_gather_kernel<W, false><<<grid, kThreads, 0, stream>>>(
        xyz, fp, cents, mask, n, s_count, k, words, r2, gxyz, op, idx, valid);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// xyz (B, N, 3) f32, feats (B, N, F) as rows of `words` words of
// `word_bytes` bytes (2, 4, 8 or 16; both base addresses aligned to it), or
// null with words = 0, cents (B, S, 3) f32, mask (B, N) bool or null; gxyz
// (B, S, k, 3) f32 or null, gfeat (B, S, k, F) in the features' type, idx
// (B, S, k) i32, valid (B, S, k) bool. Returns the CUDA error of the launch
// (0 on success), cudaErrorInvalidValue for another word size; the caller
// checked the bounds (B <= 65535).
extern "C" int group_gather_launch(const float* xyz, const void* feats,
                                   int word_bytes, int words, const float* cents,
                                   const uint8_t* mask, int b, int n,
                                   int s_count, int k, float r2, float* gxyz,
                                   void* gfeat, int* idx, bool* valid,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (word_bytes) {
    case 2:
      err = launch<uint16_t>(xyz, feats, cents, mask, b, n, s_count, k, words,
                             r2, gxyz, gfeat, idx, valid, st);
      break;
    case 4:
      err = launch<uint32_t>(xyz, feats, cents, mask, b, n, s_count, k, words,
                             r2, gxyz, gfeat, idx, valid, st);
      break;
    case 8:
      err = launch<uint2>(xyz, feats, cents, mask, b, n, s_count, k, words, r2,
                          gxyz, gfeat, idx, valid, st);
      break;
    case 16:
      err = launch<uint4>(xyz, feats, cents, mask, b, n, s_count, k, words, r2,
                          gxyz, gfeat, idx, valid, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
