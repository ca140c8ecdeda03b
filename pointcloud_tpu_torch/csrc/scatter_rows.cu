// Deterministic segment-sum of rows onto target indices (sm_90a).
//
// Replaces pointcloud_tpu/ops/pallas_kernels.py:_scatter_kernel and
// _scatter_kernel_init (reached through scatter_rows_pallas). For g (B, R, C)
// in fp32 or bf16, idx (B, R) int32 and an optional fp32 init (B, n, C):
//     out[b, t, :] = init[b, t, :] + sum_{r : idx[b, r] == t} g[b, r, :]
// in fp32 (B, n, C). Rows whose index lies outside [0, n) are dropped, as the
// TPU kernel's one-hot rows drop them.
//
// Bound on the card: bytes. g, idx and init are read once and out written
// once; there is one addition per element of g, far below the card's rate.
//
// Design: one launch, grid (ranges, B). A block owns `targets` consecutive
// targets of one cloud and needs no other block:
//   1. count: the block's warps split the cloud's rows into contiguous runs
//      in row order; each warp counts the rows of its run that fall into
//      the block's targets into a histogram of its own in shared memory
//      (lanes with equal targets found by __match_any_sync, the leader adds
//      the group's size). Indices are read a few iterations ahead.
//   2. scan: per target, the warps' counts become exclusive offsets (warp
//      order is row order) and the bucket length; a block scan of the
//      lengths gives each bucket's first slot.
//   3. place: the warps walk their runs again and write each row's id into
//      its slot: bucket start + the warp's offset + the rank among equal
//      lanes. The buckets hold their rows in increasing row order, with no
//      barrier between warps. The slots live in shared memory when the
//      block's rows fit `perm_cap`, else in the cloud's global scratch at
//      the block's own offset (the rows of the cloud with smaller targets).
//   4. sum: a group of `group` lanes owns a target; its lanes own `vec`
//      consecutive channels each, read with the widest load that every
//      row's start allows (16 bytes for 8 bf16 or 4 fp32). bf16 rows of an
//      odd width (SA2's 131 channels) start on 2-byte boundaries: a lane a
//      channel, a warp's 2-byte loads 64 contiguous bytes of a row, in
//      exactly as many passes as the row needs (pairs, with the half of the
//      rows that start 2 bytes past a word read from two words, issued more
//      instructions a row and ran slower on the card). Each lane loads a few
//      rows ahead into registers. The sum starts from init and adds the
//      bucket's rows in increasing row order, so in fp32 it is bit-equal to
//      CPU index_add_. The items are ordered by length (a counting sort),
//      and every warp takes groups of equal length: no warp diverges over
//      buckets of other lengths, and the longest go first.
//   5. long buckets (more than kPiece rows, e.g. one target that every row
//      of a cloud picks) are cut into pieces of kPiece rows, which join the
//      length classes as items of their own: each piece is summed in row
//      order (the first from init) into the cloud's global scratch of
//      pieces' sums, and after one barrier the block adds each long bucket's
//      pieces in piece order: a fixed-shape tree, deterministic, but not the
//      CPU's order (held to 1e-4 by the tests, and bit-equal to
//      ops.scatter_rows_mirror).
// The same inputs give the same bits on every run: no fp32 atomics, and no
// sum depends on which warp computes it.
//
// The TPU kernel computes the sum as one-hot (n, R-tile) @ g MXU products and
// can fold split-bf16 copies of g back to fp32 (`fold`); the CUDA cores add
// fp32 directly, so neither is carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPiece = 128;  // longest bucket one group sums in row order
constexpr int kAhead = 4;    // index reads in flight a lane
constexpr int kItemShift = 10;  // an item: local target | piece << kItemShift

// Shared memory, in ints: the per-warp histograms, then per target the
// length, first slot and first piece, the items in length order, the long
// buckets, the class counts, first items and first tasks, scalars, the slots.
struct Layout {
  int hist, len, start, pbase, items, longs, ccount, cstart, tstart, misc, perm;
  __device__ Layout(int targets, int item_cap) {
    hist = 0;
    len = hist + kWarps * targets;
    start = len + targets;
    pbase = start + targets;
    items = pbase + targets;
    longs = items + item_cap;
    ccount = longs + targets;
    cstart = ccount + kPiece + 1;
    tstart = cstart + kPiece + 2;
    misc = tstart + kPiece + 2;
    perm = misc + 4 + kWarps;
  }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Exclusive sum of one int a thread, over the block; *total gets the sum.
__device__ __forceinline__ int block_exclusive_sum(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? s_warp[warp - 1] : 0;
  *total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is free again
  return before + incl - v;
}

// Walk the warp's run of rows [lo, hi) 32 at a time, indices read kAhead
// iterations ahead: f(row, its target, its local target or -1, the lanes
// with the same local target, the rank among them).
template <typename F>
__device__ __forceinline__ void walk_rows(const int* __restrict__ idx, int lo, int hi,
                                          int t0, int tn, F&& f) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32 * kAhead) {
    int tv[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int r = base + 32 * j + lane;
      tv[j] = r < hi ? idx[r] : -1;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (base + 32 * j >= hi) break;  // warp-uniform
      const int tl = (tv[j] >= t0 && tv[j] < t0 + tn) ? tv[j] - t0 : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, tl);
      f(base + 32 * j + lane, tv[j], tl, peers, __popc(peers & lower));
      __syncwarp();
    }
  }
}

// The rows' loads and sums of one group: `kPasses` passes of vec channels a
// lane, channel (cb + (p * group + gl) * V + v).
template <typename T, int V, int kPasses>
struct GroupSum {
  static constexpr int kWords = (V * static_cast<int>(sizeof(T)) + 3) / 4;
  // rows in flight a lane: about 32 words of loads
  static constexpr int kUnroll =
      (32 / (kPasses * kWords)) >= 4 ? 4 : ((32 / (kPasses * kWords)) >= 2 ? 2 : 1);

  float acc[kPasses][V];

  __device__ __forceinline__ static void load(const T* __restrict__ row, int ch, int c,
                                              uint32_t (&w)[kWords]) {
    if (ch >= c) return;
    if constexpr (sizeof(T) == 2 && V == 1) {  // bf16 rows on 2-byte boundaries
      w[0] = *reinterpret_cast<const unsigned short*>(row + ch);
    } else if constexpr (sizeof(T) == 4) {
      const float* p = reinterpret_cast<const float*>(row + ch);
      if constexpr (V == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        w[0] = __float_as_uint(v.x), w[1] = __float_as_uint(v.y);
        w[2] = __float_as_uint(v.z), w[3] = __float_as_uint(v.w);
      } else if constexpr (V == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        w[0] = __float_as_uint(v.x), w[1] = __float_as_uint(v.y);
      } else {
        w[0] = __float_as_uint(p[0]);
      }
    } else {
      const void* p = row + ch;
      if constexpr (V == 8) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      } else if constexpr (V == 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        w[0] = v.x, w[1] = v.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
      }
    }
  }

  __device__ __forceinline__ void add(int ch, int c, const uint32_t (&w)[kWords],
                                      int p) {
    if (ch >= c) return;
    if constexpr (sizeof(T) == 2 && V == 1) {
      acc[p][0] += bf16_lo(w[0]);
    } else if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[p][v] += __uint_as_float(w[v]);
    } else {
#pragma unroll
      for (int v = 0; v < V / 2; ++v) {
        acc[p][2 * v] += bf16_lo(w[v]);
        acc[p][2 * v + 1] += bf16_hi(w[v]);
      }
    }
  }

  // acc = start (init's row or zeros), then the rows perm[s .. s + len) of
  // the cloud's g added in order
  __device__ __forceinline__ void run(const T* __restrict__ gb, const float* start_row,
                                      const int* perm, int s, int len, int cb, int c,
                                      int group, int gl) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int ch = cb + (p * group + gl) * V;
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[p][v] = (start_row != nullptr && ch + v < c) ? start_row[ch + v] : 0.f;
    }
    const int64_t stride = c;
    int i = 0;
    for (; i + kUnroll <= len; i += kUnroll) {
      uint32_t w[kUnroll][kPasses][kWords];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* row = gb + perm[s + i + u] * stride;
#pragma unroll
        for (int p = 0; p < kPasses; ++p) load(row, cb + (p * group + gl) * V, c, w[u][p]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int p = 0; p < kPasses; ++p) add(cb + (p * group + gl) * V, c, w[u][p], p);
    }
    for (; i < len; ++i) {
      uint32_t w[kPasses][kWords];
      const T* row = gb + perm[s + i] * stride;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) load(row, cb + (p * group + gl) * V, c, w[p]);
#pragma unroll
      for (int p = 0; p < kPasses; ++p) add(cb + (p * group + gl) * V, c, w[p], p);
    }
  }

  __device__ __forceinline__ void store(float* dst, int cb, int c, int group, int gl) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int ch = cb + (p * group + gl) * V;
      if (ch >= c) continue;
      if constexpr (V % 4 == 0) {
#pragma unroll
        for (int v = 0; v < V; v += 4)
          *reinterpret_cast<float4*>(dst + ch + v) =
              make_float4(acc[p][v], acc[p][v + 1], acc[p][v + 2], acc[p][v + 3]);
      } else if constexpr (V == 2) {
        *reinterpret_cast<float2*>(dst + ch) = make_float2(acc[p][0], acc[p][1]);
      } else {
        dst[ch] = acc[p][0];
      }
    }
  }
};

template <typename T, int V, int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
    segsum_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                  const float* __restrict__ init, float* __restrict__ out,
                  int* __restrict__ gperm, float* __restrict__ gpart, int rows, int n,
                  int c, int targets, int group, int perm_cap, int item_cap,
                  int cloud_pieces) {
  extern __shared__ int smem[];
  const Layout L(targets, item_cap);
  int* hist = smem + L.hist;
  int* len = smem + L.len;
  int* start = smem + L.start;
  int* pbase = smem + L.pbase;
  int* items = smem + L.items;
  int* longs = smem + L.longs;
  int* ccount = smem + L.ccount;
  int* cstart = smem + L.cstart;
  int* tstart = smem + L.tstart;
  int* misc = smem + L.misc;  // rows below, long buckets, pieces, tasks
  int* s_warp = misc + 4;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.y;
  const int t0 = blockIdx.x * targets;
  const int tn = min(targets, n - t0);
  const int* ib = idx + b * rows;
  const int run = (((rows + kWarps - 1) / kWarps) + 31) & ~31;
  const int lo = min(rows, warp * run);
  const int hi = min(rows, lo + run);

  // 1. count
  for (int i = threadIdx.x; i < kWarps * targets; i += kThreads) hist[i] = 0;
  for (int i = threadIdx.x; i <= kPiece; i += kThreads) ccount[i] = 0;
  if (threadIdx.x < 4) misc[threadIdx.x] = 0;
  __syncthreads();
  int* wh = hist + warp * targets;
  int below = 0;
  walk_rows(ib, lo, hi, t0, tn, [&](int, int t, int tl, unsigned peers, int rank) {
    below += (t >= 0 && t < t0);
    if (tl >= 0 && rank == 0) wh[tl] += __popc(peers);
  });
  below = __reduce_add_sync(0xffffffffu, below);
  if (lane == 0) atomicAdd(&misc[0], below);
  __syncthreads();

  // 2. scan: warp offsets and bucket lengths, then the buckets' first slots;
  // the items (a bucket of up to kPiece rows, or a piece of kPiece rows of a
  // longer one) counted by length
  const int per = (targets + kThreads - 1) / kThreads;  // targets a thread
  int mine = 0;
  for (int j = 0; j < per; ++j) {
    const int tl = threadIdx.x * per + j;
    if (tl >= tn) break;
    int acc = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int x = hist[w * targets + tl];
      hist[w * targets + tl] = acc;
      acc += x;
    }
    len[tl] = acc;
    mine += acc;
    if (acc <= kPiece) {
      atomicAdd(&ccount[acc], 1);
    } else {
      const int pieces = (acc + kPiece - 1) / kPiece;
      longs[atomicAdd(&misc[1], 1)] = tl;
      pbase[tl] = atomicAdd(&misc[2], pieces);
      atomicAdd(&ccount[kPiece], pieces - 1);
      atomicAdd(&ccount[acc - (pieces - 1) * kPiece], 1);
    }
  }
  int total;
  int first = block_exclusive_sum(mine, s_warp, &total);
  for (int j = 0; j < per; ++j) {
    const int tl = threadIdx.x * per + j;
    if (tl >= tn) break;
    start[tl] = first;
    first += len[tl];
  }
  const int gpw = 32 / group;  // groups a warp
  if (warp == 0) {  // classes: first item and first task of each length
    int item_carry = 0, task_carry = 0;
    for (int base = 0; base <= kPiece; base += 32) {
      const int cls = base + lane;
      const int cnt = cls <= kPiece ? ccount[cls] : 0;
      const int tasks = (cnt + gpw - 1) / gpw;
      int ci = cnt, ct = tasks;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, ci, o);
        const int v = __shfl_up_sync(0xffffffffu, ct, o);
        if (lane >= o) ci += u, ct += v;
      }
      if (cls <= kPiece) {
        cstart[cls] = item_carry + ci - cnt;
        tstart[cls] = task_carry + ct - tasks;
      }
      item_carry += __shfl_sync(0xffffffffu, ci, 31);
      task_carry += __shfl_sync(0xffffffffu, ct, 31);
    }
    if (lane == 0) {
      cstart[kPiece + 1] = item_carry;
      tstart[kPiece + 1] = task_carry;
      misc[3] = task_carry;
    }
  }
  __syncthreads();
  for (int j = 0; j < per; ++j) {  // the items by length
    const int tl = threadIdx.x * per + j;
    if (tl >= tn) break;
    const int l = len[tl];
    const int pieces = (l + kPiece - 1) / kPiece;
    for (int q = 0; q < max(pieces, 1); ++q) {
      const int pl = min(kPiece, l - q * kPiece);
      items[cstart[pl] + atomicAdd(&ccount[pl], -1) - 1] = tl | (q << kItemShift);
    }
  }

  // 3. place: slot ids in increasing row order within each bucket
  int* perm = total <= perm_cap ? smem + L.perm : gperm + b * rows + misc[0];
  walk_rows(ib, lo, hi, t0, tn, [&](int r, int, int tl, unsigned peers, int rank) {
    int slot = 0;
    if (tl >= 0) slot = start[tl] + wh[tl] + rank;
    __syncwarp();
    if (tl >= 0) {
      perm[slot] = r;
      if (rank == 0) wh[tl] += __popc(peers);
    }
  });
  __syncthreads();

  // 4. the items: a group an item, a warp's groups of one length, the
  // longest first. A bucket of up to kPiece rows goes to out; a piece of a
  // longer one to the scratch of pieces' sums.
  const T* gb = g + b * rows * static_cast<int64_t>(c);
  const float* ib_init = init != nullptr ? init + (b * n + t0) * static_cast<int64_t>(c)
                                         : nullptr;
  float* ob = out + (b * n + t0) * static_cast<int64_t>(c);
  // the block's pieces' sums: past every piece of the cloud's earlier blocks
  float* pb = gpart + (b * cloud_pieces + 2 * (misc[0] / kPiece) + blockIdx.x) *
                          static_cast<int64_t>(c);
  const int gi = lane / group;
  const int gl = lane - gi * group;
  const int chunk = group * V * kPasses;
  const int tasks = misc[3];
  for (int task = warp; task < tasks; task += kWarps) {
    const int tk = tasks - 1 - task;
    int lo_c = 0, hi_c = kPiece + 1;  // the class of task tk
    while (hi_c - lo_c > 1) {
      const int mid = (lo_c + hi_c) >> 1;
      if (tstart[mid] <= tk) lo_c = mid; else hi_c = mid;
    }
    const int item = cstart[lo_c] + (tk - tstart[lo_c]) * gpw + gi;
    if (item >= cstart[lo_c + 1]) continue;  // an idle group of the class's last task
    const int tl = items[item] & ((1 << kItemShift) - 1);
    const int q = items[item] >> kItemShift;
    const bool piece = len[tl] > kPiece;
    const float* init_row = q == 0 && ib_init != nullptr
                                ? ib_init + tl * static_cast<int64_t>(c)
                                : nullptr;
    float* dst = piece ? pb + (pbase[tl] + q) * static_cast<int64_t>(c)
                       : ob + tl * static_cast<int64_t>(c);
    GroupSum<T, V, kPasses> sum;
    for (int cb = 0; cb < c; cb += chunk) {
      sum.run(gb, init_row, perm, start[tl] + q * kPiece, lo_c, cb, c, group, gl);
      sum.store(dst, cb, c, group, gl);
    }
  }

  // 5. long buckets: their pieces' sums added in piece order
  const int n_long = misc[1];
  if (n_long == 0) return;  // block-uniform
  __syncthreads();  // every piece is summed
  for (int e = threadIdx.x; e < n_long * c; e += kThreads) {
    const int tl = longs[e / c];
    const int ch = e - (e / c) * c;
    const int pieces = (len[tl] + kPiece - 1) / kPiece;
    const float* src = pb + pbase[tl] * static_cast<int64_t>(c) + ch;
    float acc = src[0];
    for (int q = 1; q < pieces; ++q) acc += src[q * static_cast<int64_t>(c)];
    ob[tl * static_cast<int64_t>(c) + ch] = acc;
  }
}

// The launch's arguments, as scatter_rows_launch takes them.
struct Args {
  const void* g;
  const int* idx;
  const float* init;
  float* out;
  int* gperm;
  float* gpart;
  int b, rows, n, c, ranges, targets, group, perm_cap, item_cap, cloud_pieces, smem;
  cudaStream_t stream;
};

template <typename T, int V, int kPasses>
cudaError_t launch(const Args& a) {
  const cudaError_t err = hopper::allow_all_smem<segsum_kernel<T, V, kPasses>>();
  if (err != cudaSuccess) return err;
  segsum_kernel<T, V, kPasses><<<dim3(a.ranges, a.b), kThreads, a.smem, a.stream>>>(
      static_cast<const T*>(a.g), a.idx, a.init, a.out, a.gperm, a.gpart, a.rows, a.n, a.c,
      a.targets, a.group, a.perm_cap, a.item_cap, a.cloud_pieces);
  return cudaGetLastError();
}

// passes x vec: at most 16 accumulators a lane; one channel a lane takes
// any number of passes up to 8, wider loads 1 to 4 or 8
template <typename T, int V>
cudaError_t by_passes(int passes, const Args& a) {
  switch (passes) {
    case 1:
      return launch<T, V, 1>(a);
    case 2:
      return launch<T, V, 2>(a);
    case 3:
      if constexpr (V <= 4) return launch<T, V, 3>(a);
      break;
    case 4:
      if constexpr (V <= 4) return launch<T, V, 4>(a);
      break;
    case 5:
      if constexpr (V == 1) return launch<T, V, 5>(a);
      break;
    case 6:
      if constexpr (V == 1) return launch<T, V, 6>(a);
      break;
    case 7:
      if constexpr (V == 1) return launch<T, V, 7>(a);
      break;
    case 8:
      if constexpr (V <= 2) return launch<T, V, 8>(a);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// g (B, R, C) fp32 (g_bf16 == 0) or bf16, idx (B, R) i32, init (B, n, C) f32
// or null, out (B, n, C) f32; scratch `gperm` (B, R) int32 and `gpart`
// (B, cloud_pieces, C) f32. The geometry is `ops.scatter_plan`'s: `ranges`
// blocks of `targets` targets a cloud, `vec` channels a lane, `group` lanes
// and `passes` passes an item,
// `perm_cap` slots and `item_cap` items in `smem` bytes of shared memory.
// Returns the CUDA error of the launch (0 on success, cudaErrorInvalidValue
// for a geometry without a variant).
extern "C" int scatter_rows_launch(const void* g, int g_bf16, const int* idx,
                                   const float* init, float* out, int* gperm,
                                   float* gpart, int b, int rows, int n, int c,
                                   int ranges, int targets, int vec, int group,
                                   int passes, int perm_cap, int item_cap,
                                   int cloud_pieces, int smem, void* stream) {
  const Args a{g, idx, init, out, gperm, gpart, b, rows, n, c, ranges, targets, group,
               perm_cap, item_cap, cloud_pieces, smem, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (g_bf16) {
    if (vec == 8) err = by_passes<__nv_bfloat16, 8>(passes, a);
    else if (vec == 4) err = by_passes<__nv_bfloat16, 4>(passes, a);
    else if (vec == 2) err = by_passes<__nv_bfloat16, 2>(passes, a);
    else if (vec == 1) err = by_passes<__nv_bfloat16, 1>(passes, a);
  } else {
    if (vec == 4) err = by_passes<float, 4>(passes, a);
    else if (vec == 2) err = by_passes<float, 2>(passes, a);
    else if (vec == 1) err = by_passes<float, 1>(passes, a);
  }
  return static_cast<int>(err);
}
