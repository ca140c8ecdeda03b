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
// Bound on the card: bytes where the feature rows are wide (the MSG
// autoencoder's level 2: B*S*k*(12 + F*esize + 5) bytes written once), the
// distance tests where they are narrow (level 1: up to all 2,048 points a
// centroid where the ball holds fewer than k, 9 fp32 instructions a test).
//
// Design (`ops.group_gather_plan` sizes it), ball_group.cu's staged
// selection with three outputs: a block of 32 warps serves `per_block`
// centroids of one cloud, up to all of them, so the cloud is read once a
// block:
//   - staging: the points as (x, y, z, pen) go into dynamic shared memory
//     once; a cloud whose points do not fit stays in global memory (the
//     global route);
//   - selection: a warp takes kC centroids at once (1 or 2, the plan's
//     `cents`) and each point read from shared memory serves all of them
//     (ball_select::select_staged); the global route selects one centroid at
//     a time (select_first_k). The slots stay in the warp's shared array;
//     idx and valid are written by the lanes. Where one centroid's slots a
//     warp leave no room for a tile (k > 1,806), the slots are the idx
//     output itself (kIdxSlots: written once by the selection, read back by
//     the row moves through L1), so any k takes a launch;
//   - write: a centroid's xyz rows and feature rows leave as two contiguous
//     runs through the warp's tile (row_move.cuh): the xyz rows (12 bytes)
//     from the staged points, and narrow feature rows (level 1's 6-byte bf16
//     rows), as words filled into the tile and stored in 16-byte stores;
//     rows of 16-byte words and 256 bytes or more (level 2's 640-byte rows)
//     by 1-D bulk copies into the tile and one bulk store a piece (the
//     plan's `bulk`). The features are moved as raw words of W bytes (2, 4,
//     8 or 16: the widest that divides the row's bytes and both base
//     addresses, chosen by the caller).
// Not carried over from the TPU: centroids on lanes, the prefix-count matrix
// product, one one-hot MXU dot per slot and the split-bf16 hi/lo channels of
// xyz and of the index (xyz is gathered exactly; any N and k).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ball_select.cuh"
#include "hopper.cuh"
#include "row_move.cuh"

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;

// kC: centroids a warp selects at once; kStaged: the points in shared memory
// (else global); kMasked: a mask was given; kIdxSlots: the slots in idx.
template <int kC, bool kStaged, bool kMasked, bool kIdxSlots>
__global__ void __launch_bounds__(kThreads)
    group_gather_kernel(const float* __restrict__ xyz, const void* feats,
                        const float* __restrict__ cents,
                        const uint8_t* __restrict__ mask, int n, int s_count,
                        int per_block, int k, float r2, int row_bytes, int word_bytes,
                        int bulk, int tile_bytes, float* __restrict__ gxyz, void* gfeat,
                        int* __restrict__ idx, bool* __restrict__ valid) {
  // shared memory (ops.group_gather_plan's layout): each warp's mbarrier,
  // each warp's kC * k slots (the block's rounded to 16 bytes; none with
  // kIdxSlots), each warp's tile, the staged points
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBarBytes = kWarps * 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot_bytes = kIdxSlots ? 0 : (kWarps * kC * k * 4 + 15) & ~15;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp;
  int* const warp_slots = reinterpret_cast<int*>(smem + kBarBytes) + warp * kC * k;
  unsigned char* tile = smem + kBarBytes + slot_bytes + warp * tile_bytes;
  float4* pts = reinterpret_cast<float4*>(smem + kBarBytes + slot_bytes + kWarps * tile_bytes);

  const int64_t b = blockIdx.y;
  const float* xb = xyz + b * n * 3;
  const uint8_t* mb = kMasked ? mask + b * n : nullptr;
  if (kStaged) {
    for (int i = threadIdx.x; i < n; i += kThreads) pts[i] = ball_select::load_point(xb, mb, i);
  }
  if (lane == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  row_move::Tile t{tile, tile_bytes, bar, 0u, 0};
  const unsigned char* fb =
      feats != nullptr ? static_cast<const unsigned char*>(feats) + b * n * row_bytes
                       : nullptr;
  const int s_hi = min(s_count, (blockIdx.x + 1) * per_block);
  for (int s0 = blockIdx.x * per_block + warp * kC; s0 < s_hi; s0 += kWarps * kC) {
    float cx[kC][3];
    int cnt[kC];
#pragma unroll
    for (int m = 0; m < kC; ++m) {
      const bool on = s0 + m < s_hi;
      const int64_t row = b * s_count + (on ? s0 + m : s0);
#pragma unroll
      for (int d = 0; d < 3; ++d) cx[m][d] = cents[3 * row + d];
      cnt[m] = on ? 0 : k;  // a centroid past the block's end selects nothing
    }
    // the centroids' rows of idx are consecutive: centroid m's slots start
    // m * k on either way (one past the block's end is never written)
    int* const slots = kIdxSlots ? idx + (b * s_count + s0) * k : warp_slots;
    if constexpr (kStaged) {
      ball_select::select_staged<kMasked, kC>(pts, n, cx, r2, k, slots, cnt, lane);
    } else {
#pragma unroll
      for (int m = 0; m < kC; ++m)
        if (cnt[m] == 0)
          cnt[m] = ball_select::select_first_k<false>(pts, xb, mb, n, cx[m][0], cx[m][1],
                                                      cx[m][2], r2, k, slots + m * k,
                                                      lane);
    }
#pragma unroll
    for (int m = 0; m < kC; ++m) {
      if (s0 + m >= s_hi) break;
      const int64_t row = b * s_count + s0 + m;
      const int* sl = slots + m * k;
      for (int j = lane; j < k; j += 32) {
        if (!kIdxSlots) idx[row * k + j] = sl[j];
        valid[row * k + j] = j < cnt[m];
      }
      if (gxyz != nullptr) {
        if constexpr (kStaged) {
          row_move::move_words(gxyz + row * k * 3, row_move::StagedXyz{pts, sl}, k, 3, t,
                               lane);
        } else {
          row_move::move_words(gxyz + row * k * 3, row_move::GatheredRows<float>{xb, sl, 3},
                               k, 3, t, lane);
        }
      }
      if (fb != nullptr)
        row_move::move_feature_rows(static_cast<unsigned char*>(gfeat) + row * k * row_bytes,
                                    fb, sl, k, row_bytes, word_bytes, bulk != 0, t, lane);
    }
    __syncwarp();  // every lane is done with the slots
  }
  row_move::tile_free(lane);
}

template <int kC, bool kStaged, bool kMasked, bool kIdxSlots>
cudaError_t launch_variant(const float* xyz, const void* feats, const float* cents,
                           const uint8_t* mask, int b, int n, int s_count, int per_block,
                           int k, float r2, int row_bytes, int word_bytes, int bulk,
                           int tile_bytes, float* gxyz, void* gfeat, int* idx, bool* valid,
                           int blocks, int smem, cudaStream_t stream) {
  const cudaError_t err =
      hopper::allow_all_smem<group_gather_kernel<kC, kStaged, kMasked, kIdxSlots>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, b);
  group_gather_kernel<kC, kStaged, kMasked, kIdxSlots><<<grid, kThreads, smem, stream>>>(
      xyz, feats, cents, mask, n, s_count, per_block, k, r2, row_bytes, word_bytes, bulk,
      tile_bytes, gxyz, gfeat, idx, valid);
  return cudaGetLastError();
}

template <int kC>
cudaError_t launch(const float* xyz, const void* feats, const float* cents,
                   const uint8_t* mask, int b, int n, int s_count, int per_block, int k,
                   float r2, int row_bytes, int word_bytes, int bulk, int tile_bytes,
                   float* gxyz, void* gfeat, int* idx, bool* valid, int route, int blocks,
                   int smem, cudaStream_t st) {
#define GG_ARGS xyz, feats, cents, mask, b, n, s_count, per_block, k, r2, row_bytes, \
                word_bytes, bulk, tile_bytes, gxyz, gfeat, idx, valid, blocks, smem, st
  switch (route) {
    case 0:
      return mask ? launch_variant<kC, true, true, false>(GG_ARGS)
                  : launch_variant<kC, true, false, false>(GG_ARGS);
    case 1:
      return mask ? launch_variant<kC, false, true, false>(GG_ARGS)
                  : launch_variant<kC, false, false, false>(GG_ARGS);
    case 2:
      return mask ? launch_variant<kC, true, true, true>(GG_ARGS)
                  : launch_variant<kC, true, false, true>(GG_ARGS);
    case 3:
      return mask ? launch_variant<kC, false, true, true>(GG_ARGS)
                  : launch_variant<kC, false, false, true>(GG_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef GG_ARGS
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// xyz (B, N, 3) f32, feats (B, N, F) as rows of `row_bytes` bytes, moved as
// words of `word_bytes` bytes (2, 4, 8 or 16, dividing the row and both base
// addresses), or null with row_bytes = 0, cents (B, S, 3) f32, mask (B, N)
// bool or null; gxyz (B, S, k, 3) f32 or null, gfeat (B, S, k, F) in the
// features' type, idx (B, S, k) i32, valid (B, S, k) bool. The launch is
// `ops.group_gather_plan`'s: route 0 with the cloud staged in shared memory,
// 1 from global memory, plus 2 with the slots in idx; `cents` centroids a warp at once, `per_block`
// centroids a block, `blocks` blocks a cloud, a warp's tile of `tile` bytes
// (feature rows by bulk copies where `bulk`), `smem` bytes of shared memory.
// Returns the CUDA error of the launch (0 on success), cudaErrorInvalidValue
// for a launch the plan cannot give; the caller checked the bounds.
extern "C" int group_gather_launch(const float* xyz, const void* feats, int word_bytes,
                                   int row_bytes, const float* cents, const uint8_t* mask,
                                   int b, int n, int s_count, int k, float r2, float* gxyz,
                                   void* gfeat, int* idx, bool* valid, int route,
                                   int cents_per_warp, int per_block, int blocks, int tile,
                                   int bulk, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* fp = row_bytes > 0 ? feats : nullptr;  // no rows without features
  cudaError_t err = cudaErrorInvalidValue;
  if (cents_per_warp == 2) {
    err = launch<2>(xyz, fp, cents, mask, b, n, s_count, per_block, k, r2, row_bytes,
                    word_bytes, bulk, tile, gxyz, gfeat, idx, valid, route, blocks, smem,
                    st);
  } else if (cents_per_warp == 1) {
    err = launch<1>(xyz, fp, cents, mask, b, n, s_count, per_block, k, r2, row_bytes,
                    word_bytes, bulk, tile, gxyz, gfeat, idx, valid, route, blocks, smem,
                    st);
  }
  return static_cast<int>(err);
}
