// Fused backward of the Chamfer nearest-neighbour distances (sm_90a).
//
// Replaces pointcloud_tpu/ops/pallas_kernels.py:_chamfer_bwd_kernel (reached
// through chamfer_nn_bwd_pallas). For clouds x (B, N, C), y (B, M, C) fp32,
// C <= 8, the cotangents gx (B, N), gy (B, M) of the two min-distance vectors
// (already zero on masked rows) and the argmins amin_x (B, N), amin_y (B, M):
//     tx = 2 gx (x - y[amin_x])              ty = 2 gy (y - x[amin_y])
//     dx = tx - segsum(ty -> amin_y)         dy = ty - segsum(tx -> amin_x)
// both fp32. Gathered indices must lie in range (they come from the forward
// sweep); a row whose argmin lies outside the other cloud joins no sum.
//
// Bound on the card: bytes. Each input is read once and dx, dy written once
// (about 59 MB at B=256, N=M=2048, C=6: 0.0175 ms at 3.35 TB/s); the
// arithmetic is ~6C operations a point.
//
// Design: one launch, grid (2 ranges, B) of 512 threads. A block forms one
// direction (dx or dy) of one cloud, or of a range of its targets where B
// leaves SMs idle (`ops.chamfer_bwd_plan`); the two directions of a cloud
// are neighbouring blocks. On the shared route the block stages the other
// side's cloud into shared memory (its rows, cotangents and argmins) by
// three 1-D bulk copies (TMA, completed on an mbarrier that the threads
// wait on only before they read it), or by its upper 8 warps where the
// cloud is not whole 16-byte words. Then:
//   1. count: 8 warps each take a contiguous run of the summed rows in row
//      order and count the rows that fall into the block's targets into a
//      histogram of their own (lanes with equal targets found by
//      __match_any_sync, the group's leader adds its size: no atomics, no
//      barrier between warps);
//   2. scan: per target the warps' counts become each warp's first slot (a
//      prefix over warps, warp order being row order) and the bucket's
//      start (a block scan of the bucket lengths). Buckets longer than
//      kPiece rows join a list;
//   3. place: the 8 warps walk their runs again and write each row's id into
//      its slot: the warp's slot for that target plus the rank among equal
//      lanes. Each bucket then holds its rows in increasing row order;
//   4. long buckets: a bucket of more than kPiece rows (a collapsed cloud
//      sends most rows to one target) is cut into pieces of kPiece rows;
//      every piece after the first is summed from 0 in row order by a thread
//      of its own into a slot of the pieces' array;
//   5. sums: a warp takes 32 consecutive targets at a time, a lane a target:
//      it forms its own term (one gather from the staged rows), subtracts
//      its bucket's first piece in row order, then adds the later pieces'
//      sums in piece order; the results leave through the warp's tile by
//      coalesced stores (no block barrier).
// Every operation is rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn), so
// a bucket of up to kPiece rows gives the bits of the plain version's
// index_add_ on the CPU, and a longer one the bits of
// ops.scatter_rows_mirror(..., piece=32) (pieces of kPiece rows added in
// piece order): the same bits on every run, with no fp32 atomics. Clouds
// past the shared memory take the global route: the same steps with the
// clouds read from global memory and the sort's arrays in a global scratch.
// (Both directions of a cloud in one block of 1,024 threads, each staging a
// cloud for the other's own points, moved each cloud once but ran slower at
// B=256: one block an SM, ptxas held to 64 registers.)
//
// The TPU kernel builds one-hot (N, M) selectors and runs the gathers and
// segment-sums as MXU products in a C-major layout (for the MXU's lane
// padding); on the card gathers are indexed loads and sums fixed-order
// loops, O(N + M) a cloud instead of O(N M).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSortWarps = 8;  // warps that count and place, a run of rows each
constexpr int kPiece = 32;     // longest run of a bucket one thread sums
constexpr int kAhead = 4;      // argmin reads in flight a lane

__host__ __device__ inline int64_t up16(int64_t v) { return (v + 15) & ~int64_t(15); }

// Byte offsets of a block's arrays (ops.chamfer_bwd_plan's layout). Shared
// route, all in shared memory: the summed cloud's rows, cotangents and
// argmins, the permutation (16-bit), the bucket starts, the long buckets and
// their pieces' prefix, then the warps' histograms (16-bit), whose bytes the
// pieces' sums and the warps' tiles take over after the placement. Global
// route: the tiles alone in shared memory (`smem` offsets), the rest 32-bit
// in the block's global scratch.
struct Layout {
  int64_t rows, gq, amin, perm, start, longs, lpre, hist, pieces, tile, smem, scratch;
  __host__ __device__ Layout(int64_t nq, int64_t targets, int c, bool staged) {
    const int64_t isize = staged ? 2 : 4;
    const int64_t lcap = nq / (kPiece + 1) + 1;
    const int64_t pcap = nq / kPiece + 2;
    int64_t o = 0;
    rows = o;
    o += staged ? up16(nq * c * 4) : 0;
    gq = o;
    o += staged ? up16(nq * 4) : 0;
    amin = o;
    o += staged ? up16(nq * 4) : 0;
    perm = o;
    o += up16(nq * isize);
    start = o;
    o += up16((targets + 1) * 4);
    longs = o;
    o += up16(lcap * 4);
    lpre = o;
    o += up16(lcap * 4);
    hist = o;
    const int64_t hist_bytes = up16(kSortWarps * targets * isize);
    const int64_t piece_bytes = up16(pcap * c * 4);
    const int64_t tile_bytes = int64_t(kThreads) * c * 4;  // 16 warps' tiles
    if (staged) {
      pieces = hist;
      tile = hist + piece_bytes;
      smem = hist + (hist_bytes > piece_bytes + tile_bytes ? hist_bytes
                                                           : piece_bytes + tile_bytes);
      scratch = 0;
    } else {
      tile = 0;
      smem = tile_bytes;
      pieces = hist + hist_bytes;
      scratch = pieces + piece_bytes;
    }
  }
};

// Copy `count` 4-byte elements from global to shared memory, thread `tid`
// of `nthreads`, by 16-byte words where both ends allow.
template <typename T>
__device__ __forceinline__ void copy_words(T* dst, const T* src, int64_t count, int tid,
                                           int nthreads) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  if ((a & 15) == 0) {
    const int64_t words = count / 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int64_t i = tid; i < words; i += nthreads) d[i] = s[i];
    for (int64_t i = words * 4 + tid; i < count; i += nthreads) dst[i] = src[i];
  } else {
    for (int64_t i = tid; i < count; i += nthreads) dst[i] = src[i];
  }
}

// Exclusive prefix of one int a thread over the block; `total` receives the
// block's sum. Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_sum(int v, int* s_warp, int& total) {
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
  total = s_warp[kWarps - 1];
  return (warp > 0 ? s_warp[warp - 1] : 0) + incl - v;
}

// One pass of warp `warp` over its run of the summed rows, kAhead batches of
// 32 at a time: fn(local target or -1, peers, row) for every row, warp-wide.
template <typename Fn>
__device__ __forceinline__ void walk_run(const int* amin_q, int nq, int t0, int nt,
                                         int warp, int lane, Fn fn) {
  const int run = ((nq + kSortWarps - 1) / kSortWarps + 31) & ~31;
  const int lo = warp * run;
  const int hi = min(nq, lo + run);
  for (int base = lo; base < hi; base += 32 * kAhead) {
    int t[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = base + 32 * u + lane;
      t[u] = j < hi ? amin_q[j] - t0 : -1;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int key = t[u] >= 0 && t[u] < nt ? t[u] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      fn(key, peers, base + 32 * u + lane);
      __syncwarp();  // the group's writes land before the next batch reads
    }
  }
}

// kStaged: the shared route (I = uint16_t), else the global route (I = int).
template <int C, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    chamfer_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ gx, const float* __restrict__ gy,
                       const int* __restrict__ amin_x, const int* __restrict__ amin_y,
                       float* __restrict__ dx, float* __restrict__ dy, int n, int m,
                       int ranges, unsigned char* __restrict__ scratch,
                       int64_t scratch_bytes) {
  using I = typename std::conditional<kStaged, uint16_t, int>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_nlongs;
  __shared__ uint64_t s_bar;  // the staging of the summed cloud

  const int half = blockIdx.x / ranges;  // 0: dx (targets x, summed rows y); 1: dy
  const int range = blockIdx.x - half * ranges;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned lower = (1u << lane) - 1u;
  const bool xs = half == 0;
  const int np = xs ? n : m;  // the targets' side
  const int nq = xs ? m : n;  // the summed rows' side
  const int64_t b = blockIdx.y;
  const float* q = (xs ? y : x) + b * nq * C;
  const float* gq = (xs ? gy : gx) + b * nq;
  const int* aq = (xs ? amin_y : amin_x) + b * nq;
  float* out = (xs ? dx : dy) + b * np * C;
  const int targets = (np + ranges - 1) / ranges;
  const int t0 = range * targets;
  const int nt = min(targets, np - t0);

  const Layout lay(nq, targets, C, kStaged);
  unsigned char* base =
      kStaged ? smem
              : scratch + (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                              scratch_bytes;
  float* s_rows = reinterpret_cast<float*>(base + lay.rows);
  float* s_gq = reinterpret_cast<float*>(base + lay.gq);
  int* s_aq = reinterpret_cast<int*>(base + lay.amin);
  const float* rows = kStaged ? s_rows : q;
  const float* gqv = kStaged ? s_gq : gq;
  const int* aqv = kStaged ? s_aq : aq;
  const float* p = (xs ? x : y) + b * np * C;  // the block's own points
  const float* gp = (xs ? gx : gy) + b * np;
  const int* ap = (xs ? amin_x : amin_y) + b * np;
  I* perm = reinterpret_cast<I*>(base + lay.perm);
  int* start = reinterpret_cast<int*>(base + lay.start);
  int* longs = reinterpret_cast<int*>(base + lay.longs);
  int* lpre = reinterpret_cast<int*>(base + lay.lpre);
  I* hist = reinterpret_cast<I*>(base + lay.hist);
  float* pieces = reinterpret_cast<float*>(base + lay.pieces);
  float* tile = reinterpret_cast<float*>(smem + lay.tile);

  // the staging: three 1-D bulk copies where the three arrays are whole
  // 16-byte words, else the upper 8 warps, each arriving when done
  const uint32_t row_bytes = static_cast<uint32_t>(nq) * C * 4;
  const bool bulk = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(gq) |
                      reinterpret_cast<uintptr_t>(aq) | row_bytes | nq * 4) & 15) == 0;
  if (nt <= 0) return;  // block-uniform: a range past this direction's points
  if (kStaged && tid == 0) {
    hopper::mbar_init(&s_bar, bulk ? 1 : kThreads - kSortWarps * 32);
    hopper::fence_barrier_init();
  }
  if (tid == 0) s_nlongs = 0;
  for (int i = tid; i < kSortWarps * nt; i += kThreads) hist[i] = 0;
  __syncthreads();  // the mbarrier is initialised, the histograms zero
  if (kStaged) {
    if (bulk && tid == 0) {
      hopper::mbar_expect_tx(&s_bar, row_bytes + 8 * nq);
      hopper::bulk_load_1d(s_rows, q, row_bytes, &s_bar);
      hopper::bulk_load_1d(s_gq, gq, 4 * nq, &s_bar);
      hopper::bulk_load_1d(s_aq, aq, 4 * nq, &s_bar);
    } else if (!bulk && warp >= kSortWarps) {
      const int ct = tid - kSortWarps * 32;
      const int nc = kThreads - kSortWarps * 32;
      copy_words(s_rows, q, static_cast<int64_t>(nq) * C, ct, nc);
      copy_words(s_gq, gq, nq, ct, nc);
      copy_words(s_aq, aq, nq, ct, nc);
      hopper::mbar_arrive(&s_bar);
    }
  }

  // 1. count (8 warps), the argmins read from global memory
  if (warp < kSortWarps) {
    I* h = hist + warp * nt;
    walk_run(aq, nq, t0, nt, warp, lane, [&](int key, unsigned peers, int) {
      if (key >= 0 && (peers & lower) == 0) h[key] = static_cast<I>(h[key] + __popc(peers));
    });
  }
  __syncthreads();

  // 2. scan: bucket starts, each warp's first slot of a target, long buckets
  {
    const int per = (nt + kThreads - 1) / kThreads;
    const int tb = tid * per;
    const int te = min(nt, tb + per);
    int sum = 0;
    for (int t = tb; t < te; ++t)
#pragma unroll
      for (int w = 0; w < kSortWarps; ++w) sum += hist[w * nt + t];
    int total;
    int s = block_exclusive_sum(sum, s_warp, total);
    for (int t = tb; t < te; ++t) {
      start[t] = s;
      int slot = s;
#pragma unroll
      for (int w = 0; w < kSortWarps; ++w) {
        const int c = hist[w * nt + t];
        hist[w * nt + t] = static_cast<I>(slot);
        slot += c;
      }
      if (slot - s > kPiece) longs[atomicAdd(&s_nlongs, 1)] = t;
      s = slot;
    }
    if (tid == 0) start[nt] = total;
  }
  if (kStaged) hopper::mbar_wait(&s_bar, 0);  // the staged cloud
  __syncthreads();

  // 3. place (8 warps) | the long buckets' pieces after their first, as an
  // inclusive prefix in list order (one warp)
  if (warp < kSortWarps) {
    I* h = hist + warp * nt;
    walk_run(aqv, nq, t0, nt, warp, lane, [&](int key, unsigned peers, int j) {
      const int slot = key >= 0 ? static_cast<int>(h[key]) : 0;
      __syncwarp();  // every lane of the group has read the slot
      if (key >= 0) {
        perm[slot + __popc(peers & lower)] = static_cast<I>(j);
        if ((peers & lower) == 0) h[key] = static_cast<I>(slot + __popc(peers));
      }
    });
  } else if (warp == kSortWarps) {
    const int nl = s_nlongs;
    int carry = 0;
    for (int i0 = 0; i0 < nl; i0 += 32) {
      const int i = i0 + lane;
      int v = 0;
      if (i < nl) {
        const int t = longs[i];
        v = (start[t + 1] - start[t] + kPiece - 1) / kPiece - 1;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (i < nl) lpre[i] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();

  // 4. every piece after a long bucket's first, from 0, in row order
  const int nl = s_nlongs;
  if (nl > 0) {
    const int items = lpre[nl - 1];
    for (int it = tid; it < items; it += kThreads) {
      int lo = 0, hi = nl - 1;  // the first long bucket whose prefix passes it
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (lpre[mid] > it) hi = mid; else lo = mid + 1;
      }
      const int t = longs[lo];
      const int piece = 1 + it - (lo > 0 ? lpre[lo - 1] : 0);
      const int s = start[t];
      const int e = min(start[t + 1], s + (piece + 1) * kPiece);
      float pv[C], acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        pv[c] = p[static_cast<int64_t>(t0 + t) * C + c];
        acc[c] = 0.f;
      }
      for (int k = s + piece * kPiece; k < e; ++k) {
        const int64_t r = perm[k];
        const float sr = __fmul_rn(2.0f, gqv[r]);
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[c] = __fsub_rn(acc[c], __fmul_rn(sr, __fsub_rn(rows[r * C + c], pv[c])));
      }
      float* dst = pieces + static_cast<int64_t>(s / kPiece + piece) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) dst[c] = acc[c];
    }
    __syncthreads();
  }

  // 5. the sums: a warp takes 32 consecutive targets at a time, a lane a
  // target; the results leave through the warp's tile by coalesced stores
  float* wt = tile + warp * 32 * C;
  for (int tb = warp * 32; tb < nt; tb += kThreads) {
    const int t = tb + lane;
    if (t < nt) {
      const int64_t j = ap[t0 + t];
      const float g2 = __fmul_rn(2.0f, gp[t0 + t]);
      float pv[C], acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        pv[c] = p[static_cast<int64_t>(t0 + t) * C + c];
        acc[c] = __fmul_rn(g2, __fsub_rn(pv[c], rows[j * C + c]));
      }
      const int s = start[t];
      const int len = start[t + 1] - s;
      const int e = s + min(len, kPiece);
      for (int k = s; k < e; ++k) {
        const int64_t r = perm[k];
        const float sr = __fmul_rn(2.0f, gqv[r]);
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[c] = __fsub_rn(acc[c], __fmul_rn(sr, __fsub_rn(rows[r * C + c], pv[c])));
      }
      for (int piece = 1; piece * kPiece < len; ++piece) {
        const float* src = pieces + static_cast<int64_t>(s / kPiece + piece) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], src[c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) wt[lane * C + c] = acc[c];
    }
    __syncwarp();
    const int words = min(32, nt - tb) * C;
    float* dst = out + static_cast<int64_t>(t0 + tb) * C;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (lane + 32 * k < words) dst[lane + 32 * k] = wt[lane + 32 * k];
    __syncwarp();  // the tile is free again
  }
}

template <int C>
cudaError_t launch(const float* x, const float* y, const float* gx, const float* gy,
                   const int* amin_x, const int* amin_y, float* dx, float* dy,
                   unsigned char* scratch, int b, int n, int m, int ranges, int staged,
                   int smem, int64_t scratch_bytes, cudaStream_t s) {
  const dim3 grid(2 * ranges, b);
  if (staged) {
    const cudaError_t err = hopper::allow_all_smem<chamfer_bwd_kernel<C, true>>();
    if (err != cudaSuccess) return err;
    chamfer_bwd_kernel<C, true><<<grid, kThreads, smem, s>>>(
        x, y, gx, gy, amin_x, amin_y, dx, dy, n, m, ranges, scratch, scratch_bytes);
  } else {
    chamfer_bwd_kernel<C, false><<<grid, kThreads, smem, s>>>(
        x, y, gx, gy, amin_x, amin_y, dx, dy, n, m, ranges, scratch, scratch_bytes);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors; the
// launch is `ops.chamfer_bwd_plan`'s: `ranges` blocks a direction of a
// cloud, the shared route (`staged`) or the global one with `scratch_bytes`
// of `scratch` a block, `smem` bytes of shared memory. Returns the CUDA
// error of the launch (0 on success); the caller checked the bounds
// (1 <= C <= 8, B <= 65535).
extern "C" int chamfer_bwd_launch(const float* x, const float* y, const float* gx,
                                  const float* gy, const int* amin_x, const int* amin_y,
                                  float* dx, float* dy, void* scratch, int b, int n, int m,
                                  int c, int ranges, int staged, int smem,
                                  long long scratch_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
#define CHAMFER_BWD_CASE(C_)                                                        \
  case C_:                                                                          \
    return static_cast<int>(launch<C_>(x, y, gx, gy, amin_x, amin_y, dx, dy, sc, b, \
                                       n, m, ranges, staged, smem,                 \
                                       scratch_bytes, s));
  switch (c) {
    CHAMFER_BWD_CASE(1)
    CHAMFER_BWD_CASE(2)
    CHAMFER_BWD_CASE(3)
    CHAMFER_BWD_CASE(4)
    CHAMFER_BWD_CASE(5)
    CHAMFER_BWD_CASE(6)
    CHAMFER_BWD_CASE(7)
    CHAMFER_BWD_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CHAMFER_BWD_CASE
}
