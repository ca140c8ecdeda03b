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
// Membership is ball_select.cuh's: a point is inside when
// ((pen + dx^2) + dy^2) + dz^2 <= r2 (the TPU kernel's formula and order, in
// rounded intrinsics).
//
// Bound on the card: bytes where the grouped rows are wide (SA2: B*S*k*(3+F)
// elements written once), the distance tests where they are narrow (SA1:
// ~1,300 points tested a centroid, 9 fp32 instructions each without FMA).
//
// Design (`ops.ball_group_plan` sizes it): a block of 32 warps serves
// `per_block` centroids of one cloud, up to all of them, so the cloud is read
// once a block, not once every 16 centroids (32 warps, not 16: SA2's staged
// cloud leaves room for one block an SM, and its write needs the warps):
//   - staging: the points as (x, y, z, pen) and, where they fit, the
//     features (16-byte copies where the cloud's rows allow) go into dynamic
//     shared memory once; a cloud whose points do not fit stays in global
//     memory (the global route);
//   - selection: a warp takes kCents centroids at once and each point read
//     from shared memory serves all of them (ball_select::select_staged,
//     four batches of 32 points a round); the global route selects one
//     centroid at a time (select_first_k). The slots stay in the warp's
//     shared array, and idx and valid are written once. Where 32 warps'
//     slots pass the shared memory (k > 780), the slots are the idx output
//     itself: the selection writes each slot there once and the write below
//     reads it back (L1), so any k takes a launch;
//   - write: a centroid's output is one contiguous run of k * (3+F)
//     elements. The warp assembles it in its shared tile and the tile leaves
//     in 16-byte stores, each piece starting on a 16-byte boundary of the
//     output; only the run's ragged first and last 16 bytes store element by
//     element. Rows of 64 bytes or more are written row by row: three lanes
//     centre the coordinates, and the features are copied as 32-bit words
//     (funnel-shifted where a row's place is 2 bytes past a word: SA2's
//     262-byte rows alternate). Narrower rows (SA1's 12 bytes) are filled
//     element by element, lanes on consecutive elements; a lane's next
//     element is 32 on, a fixed (row, channel) step, so no element needs a
//     division or a loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ball_select.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kCents = 2;  // centroids a warp selects at once
constexpr int kWideRow = 64;  // bytes of an output row written row by row

__device__ __forceinline__ float to_out(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

// Copy `bytes` bytes from global to 16-byte aligned shared memory, the
// block's threads together, in the widest words both ends allow.
__device__ __forceinline__ void stage_bytes(void* dst, const void* src, int64_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(bytes);
  if ((a & 15) == 0) {
    const uint4* s = static_cast<const uint4*>(src);
    uint4* d = static_cast<uint4*>(dst);
    for (int64_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
  } else if ((a & 3) == 0) {
    const uint32_t* s = static_cast<const uint32_t*>(src);
    uint32_t* d = static_cast<uint32_t*>(dst);
    for (int64_t i = threadIdx.x; i < bytes / 4; i += blockDim.x) d[i] = s[i];
  } else {
    const unsigned short* s = static_cast<const unsigned short*>(src);
    unsigned short* d = static_cast<unsigned short*>(dst);
    for (int64_t i = threadIdx.x; i < bytes / 2; i += blockDim.x) d[i] = s[i];
  }
}

// One centroid's run of k rows of c = 3 + f elements at `ob`, assembled by
// the warp in `tile` (tile_elems elements, a multiple of 16 bytes) and
// stored in 16-byte chunks (see the note above). `fsrc` holds the cloud's
// features (shared or global memory), `pts` its staged points (kStaged) or
// `xb` its xyz in global memory.
template <typename T, bool kStaged>
__device__ __forceinline__ void store_run(T* __restrict__ ob, const int* slots, int k,
                                          int c, int f, const float4* pts,
                                          const float* __restrict__ xb, const T* fsrc,
                                          float cx, float cy, float cz, T* tile,
                                          int tile_elems, int lane) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  const int total = k * c;
  const int head =
      static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(ob) & 15)) & 15) / sizeof(T));
  // a lane's next element is 32 on: jd rows and cd channels
  const int jd = 32 / c;
  const int cd = 32 - jd * c;
  for (int p0 = head > 0 ? head - kPer : 0; p0 < total; p0 += tile_elems) {
    const int pn = min(tile_elems, total - p0);
    int e = p0 + lane;
    int j = e >= 0 ? e / c : -((-e + c - 1) / c);  // floor division, once a piece
    int ch = e - j * c;
#pragma unroll 4
    for (int i = lane; i < pn; i += 32) {
      T v = T();
      if (e >= 0) {
        const int p = slots[j];
        if (ch < 3) {
          float coord;
          if (kStaged) {
            const float4 pt = pts[p];
            coord = ch == 0 ? pt.x : ch == 1 ? pt.y : pt.z;
          } else {
            coord = xb[3 * static_cast<int64_t>(p) + ch];
          }
          v = to_out(__fsub_rn(coord, ch == 0 ? cx : ch == 1 ? cy : cz), T());
        } else {
          v = fsrc[static_cast<int64_t>(p) * f + (ch - 3)];
        }
      }
      tile[i] = v;
      e += 32;
      j += jd;
      ch += cd;
      if (ch >= c) {
        ch -= c;
        ++j;
      }
    }
    __syncwarp();
    for (int q = lane; q * kPer < pn; q += 32) {
      const int e0 = p0 + q * kPer;
      if (e0 >= 0 && e0 + kPer <= total) {
        *reinterpret_cast<uint4*>(ob + e0) = *reinterpret_cast<const uint4*>(tile + q * kPer);
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          if (e0 + i >= 0 && e0 + i < total) ob[e0 + i] = tile[q * kPer + i];
      }
    }
    __syncwarp();  // the tile is free again
  }
}

// Copy m elements from `sp` to `dp` (the warp's lanes together) as 32-bit
// words: a first element alone where dp is 2 bytes past a word, then words,
// each taken whole or, where sp is 2 bytes past a word, from two words by a
// funnel shift (the word past the last element may be read, never used), and
// a last element alone.
__device__ __forceinline__ void copy_words(float* __restrict__ dp,
                                           const float* __restrict__ sp, int m, int lane) {
  for (int i = lane; i < m; i += 32) dp[i] = sp[i];
}
__device__ __forceinline__ void copy_words(__nv_bfloat16* __restrict__ dp,
                                           const __nv_bfloat16* __restrict__ sp, int m,
                                           int lane) {
  if (m <= 0) return;
  if (reinterpret_cast<uintptr_t>(dp) & 2) {
    if (lane == 0) dp[0] = sp[0];
    ++dp, ++sp, --m;
  }
  const int words = m / 2;
  uint32_t* dw = reinterpret_cast<uint32_t*>(dp);
  if ((reinterpret_cast<uintptr_t>(sp) & 2) == 0) {
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(sp);
    for (int w = lane; w < words; w += 32) dw[w] = sw[w];
  } else {
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(sp - 1);
    for (int w = lane; w < words; w += 32) dw[w] = __funnelshift_r(sw[w], sw[w + 1], 16);
  }
  if ((m & 1) && lane == 0) dp[m - 1] = sp[m - 1];
}

// As store_run, for wide rows: the warp writes whole rows into its tile, each
// row's three centred coordinates by three lanes and its features by
// copy_words, as many rows as the tile holds; the tile then leaves in 16-byte
// chunks up to the last 16-byte boundary, and the few elements past it move
// to the tile's front for the next rows.
template <typename T, bool kStaged>
__device__ __forceinline__ void store_run_rows(T* __restrict__ ob, const int* slots, int k,
                                               int c, int f, const float4* pts,
                                               const float* __restrict__ xb,
                                               const T* __restrict__ fsrc, float cx,
                                               float cy, float cz, T* __restrict__ tile,
                                               int tile_elems, int lane) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  const int total = k * c;
  const int head =
      static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(ob) & 15)) & 15) / sizeof(T));
  int p0 = head > 0 ? head - kPer : 0;  // the tile's first element in the run
  for (int j = 0; j < k;) {
    const int j1 = min(k, (p0 + tile_elems) / c);  // rows j .. j1 - 1 fit
#pragma unroll 2
    for (int jj = j; jj < j1; ++jj) {
      const int p = slots[jj];
      T* row = tile + (jj * c - p0);
      if (lane < 3) {
        const float coord = kStaged ? (lane == 0   ? pts[p].x
                                       : lane == 1 ? pts[p].y
                                                   : pts[p].z)
                                    : xb[3 * static_cast<int64_t>(p) + lane];
        row[lane] = to_out(__fsub_rn(coord, lane == 0 ? cx : lane == 1 ? cy : cz), T());
      }
      copy_words(row + 3, fsrc + static_cast<int64_t>(p) * f, f, lane);
    }
    __syncwarp();
    const int end = j1 == k ? total : p0 + (j1 * c - p0) / kPer * kPer;
    for (int q = lane; p0 + q * kPer < end; q += 32) {
      const int e0 = p0 + q * kPer;
      if (e0 >= 0 && e0 + kPer <= total) {
        *reinterpret_cast<uint4*>(ob + e0) = *reinterpret_cast<const uint4*>(tile + q * kPer);
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          if (e0 + i >= 0 && e0 + i < total) ob[e0 + i] = tile[q * kPer + i];
      }
    }
    T carry = T();
    if (lane < j1 * c - end) carry = tile[end - p0 + lane];
    __syncwarp();
    if (lane < j1 * c - end) tile[lane] = carry;
    __syncwarp();
    p0 = end;
    j = j1;
  }
}

// kStaged: the points in shared memory (else global); kFeats: the features
// staged too; kMasked: a mask was given; kWrite: write the grouped rows (the
// diagnostic entry runs without); kIdxSlots: the slots live in the idx output
// itself, not in shared memory (k past what 32 warps' shared slots hold).
template <typename T, bool kStaged, bool kFeats, bool kMasked, bool kWrite, bool kIdxSlots>
__global__ void __launch_bounds__(kThreads)
    ball_group_kernel(const float* __restrict__ xyz, const T* __restrict__ feats,
                      const float* __restrict__ cents,
                      const uint8_t* __restrict__ mask, int n, int s_count,
                      int per_block, int k, int f, float r2, int tile_bytes,
                      T* __restrict__ out, int* __restrict__ idx,
                      bool* __restrict__ valid) {
  // shared memory: each warp's kCents * k slots (none with kIdxSlots) and
  // tile, then the staged points and features (ops.ball_group_plan's layout)
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot_bytes = kIdxSlots ? 0 : (kWarps * kCents * k * 4 + 15) & ~15;
  int* const warp_slots = reinterpret_cast<int*>(smem) + warp * kCents * k;
  T* tile = reinterpret_cast<T*>(smem + slot_bytes + warp * tile_bytes);
  float4* pts = reinterpret_cast<float4*>(smem + slot_bytes + kWarps * tile_bytes);
  T* sfeats = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(pts) +
                                   (kStaged ? 16 * n : 0));

  const int64_t b = blockIdx.y;
  const float* xb = xyz + b * n * 3;
  const uint8_t* mb = kMasked ? mask + b * n : nullptr;
  const T* fb = feats != nullptr ? feats + b * n * static_cast<int64_t>(f) : nullptr;
  if (kStaged) {
    for (int i = threadIdx.x; i < n; i += kThreads)
      pts[i] = ball_select::load_point(xb, mb, i);
  }
  if (kFeats && kWrite) stage_bytes(sfeats, fb, static_cast<int64_t>(n) * f * sizeof(T));
  __syncthreads();
  const T* fsrc = kFeats ? sfeats : fb;

  const int s_hi = min(s_count, (blockIdx.x + 1) * per_block);
  const int c = 3 + f;
  for (int s0 = blockIdx.x * per_block + warp * kCents; s0 < s_hi;
       s0 += kWarps * kCents) {
    float cx[kCents][3];
    int cnt[kCents];
#pragma unroll
    for (int m = 0; m < kCents; ++m) {
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
      ball_select::select_staged<kMasked, kCents>(pts, n, cx, r2, k, slots, cnt, lane);
    } else {
#pragma unroll
      for (int m = 0; m < kCents; ++m)
        if (cnt[m] == 0)
          cnt[m] = ball_select::select_first_k<false>(pts, xb, mb, n, cx[m][0], cx[m][1],
                                                      cx[m][2], r2, k, slots + m * k,
                                                      lane);
    }
#pragma unroll
    for (int m = 0; m < kCents; ++m) {
      if (s0 + m >= s_hi) break;
      const int64_t row = b * s_count + s0 + m;
      const int* sl = slots + m * k;
      for (int j = lane; j < k; j += 32) {
        if (!kIdxSlots) idx[row * k + j] = sl[j];
        valid[row * k + j] = j < cnt[m];
      }
      if (kWrite) {
        const int tile_elems = tile_bytes / static_cast<int>(sizeof(T));
        if (c * static_cast<int>(sizeof(T)) >= kWideRow) {
          store_run_rows<T, kStaged>(out + row * k * c, sl, k, c, f, pts, xb, fsrc,
                                     cx[m][0], cx[m][1], cx[m][2], tile, tile_elems, lane);
        } else {
          store_run<T, kStaged>(out + row * k * c, sl, k, c, f, pts, xb, fsrc, cx[m][0],
                                cx[m][1], cx[m][2], tile, tile_elems, lane);
        }
      }
    }
    __syncwarp();  // every lane is done with the slots
  }
}

template <typename T, bool kStaged, bool kFeats, bool kMasked, bool kWrite, bool kIdxSlots>
cudaError_t launch_variant(const float* xyz, const T* feats, const float* cents,
                           const uint8_t* mask, int b, int n, int s_count, int per_block,
                           int k, int f, float r2, int tile_bytes, T* out, int* idx,
                           bool* valid, int smem, cudaStream_t stream) {
  auto kernel = ball_group_kernel<T, kStaged, kFeats, kMasked, kWrite, kIdxSlots>;
  const cudaError_t err = hopper::allow_all_smem<
      ball_group_kernel<T, kStaged, kFeats, kMasked, kWrite, kIdxSlots>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((s_count + per_block - 1) / per_block, b);
  kernel<<<grid, kThreads, smem, stream>>>(xyz, feats, cents, mask, n, s_count,
                                           per_block, k, f, r2, tile_bytes, out, idx,
                                           valid);
  return cudaGetLastError();
}

template <typename T, bool kWrite, bool kIdxSlots>
cudaError_t launch(const float* xyz, const void* feats, const float* cents,
                   const uint8_t* mask, int b, int n, int s_count, int per_block, int k,
                   int f, float r2, int tile_bytes, void* out, int* idx, bool* valid,
                   int staged, int stage_feats, int smem, cudaStream_t st) {
  const T* fp = static_cast<const T*>(feats);
  T* op = static_cast<T*>(out);
#define BALL_ARGS xyz, fp, cents, mask, b, n, s_count, per_block, k, f, r2, tile_bytes, \
                  op, idx, valid, smem, st
  if (!staged) {
    return mask ? launch_variant<T, false, false, true, kWrite, kIdxSlots>(BALL_ARGS)
                : launch_variant<T, false, false, false, kWrite, kIdxSlots>(BALL_ARGS);
  }
  if (stage_feats) {
    return mask ? launch_variant<T, true, true, true, kWrite, kIdxSlots>(BALL_ARGS)
                : launch_variant<T, true, true, false, kWrite, kIdxSlots>(BALL_ARGS);
  }
  return mask ? launch_variant<T, true, false, true, kWrite, kIdxSlots>(BALL_ARGS)
              : launch_variant<T, true, false, false, kWrite, kIdxSlots>(BALL_ARGS);
#undef BALL_ARGS
}

template <typename T, bool kWrite>
cudaError_t launch(const float* xyz, const void* feats, const float* cents,
                   const uint8_t* mask, int b, int n, int s_count, int per_block, int k,
                   int f, float r2, int tile_bytes, void* out, int* idx, bool* valid,
                   int staged, int stage_feats, int idx_slots, int smem, cudaStream_t st) {
  return idx_slots ? launch<T, kWrite, true>(xyz, feats, cents, mask, b, n, s_count,
                                             per_block, k, f, r2, tile_bytes, out, idx,
                                             valid, staged, stage_feats, smem, st)
                   : launch<T, kWrite, false>(xyz, feats, cents, mask, b, n, s_count,
                                              per_block, k, f, r2, tile_bytes, out, idx,
                                              valid, staged, stage_feats, smem, st);
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// xyz (B, N, 3) f32, feats (B, N, F) f32 (feats_bf16 == 0) or bf16, or null
// with F = 0, cents (B, S, 3) f32, mask (B, N) bool or null; out
// (B, S, k, 3+F) in the features' dtype (f32 without features), idx
// (B, S, k) i32, valid (B, S, k) bool. The geometry is `ops.ball_group_plan`'s:
// `per_block` centroids a block, a warp's tile of `tile_bytes`, the points
// staged (`staged`) and the features too (`stage_feats`), the slots in idx
// (`idx_slots`) or in shared memory, in `smem` bytes of shared memory.
// Returns the CUDA error of the launch (0 on success); the caller checked
// the bounds.
extern "C" int ball_group_launch(const float* xyz, const void* feats, int feats_bf16,
                                 const float* cents, const uint8_t* mask, int b, int n,
                                 int s_count, int k, int f, float r2, void* out, int* idx,
                                 bool* valid, int per_block, int tile_bytes, int staged,
                                 int stage_feats, int idx_slots, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      feats_bf16 ? launch<__nv_bfloat16, true>(xyz, feats, cents, mask, b, n, s_count,
                                               per_block, k, f, r2, tile_bytes, out, idx,
                                               valid, staged, stage_feats, idx_slots, smem,
                                               st)
                 : launch<float, true>(xyz, feats, cents, mask, b, n, s_count, per_block,
                                       k, f, r2, tile_bytes, out, idx, valid, staged,
                                       stage_feats, idx_slots, smem, st);
  return static_cast<int>(err);
}

// Diagnostic entry (bound by chip_smoke.py only): the same launch, staging
// and selection with idx and valid, but no grouped rows and no features.
extern "C" int ball_group_select_launch(const float* xyz, const float* cents,
                                        const uint8_t* mask, int b, int n, int s_count,
                                        int k, float r2, int* idx, bool* valid,
                                        int per_block, int tile_bytes, int staged,
                                        int idx_slots, int smem, void* stream) {
  return static_cast<int>(launch<float, false>(
      xyz, nullptr, cents, mask, b, n, s_count, per_block, k, 0, r2, tile_bytes, nullptr,
      idx, valid, staged, 0, idx_slots, smem, static_cast<cudaStream_t>(stream)));
}
