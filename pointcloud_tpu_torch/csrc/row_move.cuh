// The row mover of knn_group.cu and group_gather.cu: a warp writes one
// centroid's k gathered rows as one contiguous run of the output, through
// its own tile in shared memory.
//
// Three ways; the caller's plan picks one from the rows' alignment and width
// (each measured the fastest on its rows):
//   - move_bulk (rows of 16-byte words, 256 bytes or more): each piece of
//     the run that fits half the tile arrives by 1-D bulk copies
//     (cp.async.bulk global -> shared, a row or a row's part each, issued by
//     the warp's lanes together and completed on the warp's mbarrier) and
//     leaves as one bulk store (shared -> global). The two halves alternate,
//     so a piece's loads overlap the store of the one before; lane 0 issues
//     every store and waits for its reads before a half is loaded again. No
//     register holds a row.
//   - prefetch_run / drain_run (a run of 16-byte words that fits the tile):
//     the run's loads leave (cp.async, 16 bytes a lane) and the warp goes on
//     to its next centroid's selection; the run is stored from the tile
//     after it.
//   - move_words (any row of whole W-byte words, W = 2, 4, 8 or 16): the
//     lanes fill the tile with the run's words, four loads in flight a lane
//     before their shared stores, then the tile leaves in 16-byte stores on
//     the output's 16-byte boundaries; only the run's ragged first and last
//     16 bytes are stored word by word. A source functor src(j, w) gives
//     word w of the run's row j (a gathered row, or a staged point's
//     coordinate).
// move_words first waits until lane 0's bulk stores have read the tile
// (tile_free); a warp calls tile_free once more before it exits, so that no
// store reads shared memory that another block may be given.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace row_move {

// The state of a warp's tile between runs: its mbarrier's parity and the
// half the next bulk piece goes to.
struct Tile {
  unsigned char* base;  // the warp's tile, 16-byte aligned
  int bytes;            // its size, a multiple of 32
  uint64_t* bar;        // the warp's mbarrier (initialised with one arrival)
  uint32_t phase;
  int half;
};

// Lane 0's bulk stores have read the whole tile: the warp may write it.
__device__ __forceinline__ void tile_free(int lane) {
  if (lane == 0) hopper::bulk_wait_read<0>();
  __syncwarp();
}

// Rows slots[0..k) of `row_bytes` bytes (a multiple of 16) from `src` (16-byte
// aligned) to the contiguous run at `dst` (16-byte aligned).
__device__ __forceinline__ void move_bulk(unsigned char* dst, const unsigned char* src,
                                          const int* slots, int k, int row_bytes,
                                          Tile& t, int lane) {
  const int half = (t.bytes / 2) & ~15;
  const int64_t total = static_cast<int64_t>(k) * row_bytes;
  hopper::fence_proxy_async();  // the warp's own stores to the tile come first
  for (int64_t p0 = 0; p0 < total; p0 += half) {
    const int pn = static_cast<int>(min(static_cast<int64_t>(half), total - p0));
    unsigned char* buf = t.base + t.half * half;
    if (lane == 0) {
      hopper::bulk_wait_read<1>();  // the store two pieces back has left this half
      hopper::mbar_expect_tx(t.bar, static_cast<uint32_t>(pn));
    }
    __syncwarp();
    const int j0 = static_cast<int>(p0 / row_bytes);
    const int j1 = static_cast<int>((p0 + pn - 1) / row_bytes);
    for (int j = j0 + lane; j <= j1; j += 32) {
      const int64_t r0 = static_cast<int64_t>(j) * row_bytes;
      const int64_t s = max(p0, r0);
      const int64_t e = min(p0 + pn, r0 + row_bytes);
      hopper::bulk_load_1d(buf + (s - p0),
                           src + static_cast<int64_t>(slots[j]) * row_bytes + (s - r0),
                           static_cast<uint32_t>(e - s), t.bar);
    }
    hopper::mbar_wait(t.bar, t.phase);
    t.phase ^= 1u;
    if (lane == 0) {
      hopper::bulk_store_1d(dst + p0, buf, static_cast<uint32_t>(pn));
      hopper::bulk_commit();
    }
    t.half ^= 1;
  }
}

// Words src(j, w) of the k rows of `wpr` W-byte words each to the run at
// `dst` (W-byte aligned), through the tile (a multiple of 16 bytes).
template <typename W, typename Src>
__device__ __forceinline__ void move_words(W* __restrict__ dst, const Src& src, int k,
                                           int wpr, const Tile& t, int lane) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(W));  // words a 16-byte chunk
  constexpr int kFly = 4;                                   // loads in flight a lane
  W* tile = reinterpret_cast<W*>(t.base);
  const int tile_words = t.bytes / static_cast<int>(sizeof(W));
  const int total = k * wpr;
  // words of the run before the output's first 16-byte boundary
  const int head =
      static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / sizeof(W));
  // a lane's next word is 32 on: jd rows and wd words
  const int jd = 32 / wpr;
  const int wd = 32 - jd * wpr;
  tile_free(lane);
  for (int p0 = head > 0 ? head - kPer : 0; p0 < total; p0 += tile_words) {
    const int pn = min(tile_words, total - p0);
    int e = p0 + lane;
    int j = e >= 0 ? e / wpr : -((-e + wpr - 1) / wpr);  // floor division, once a piece
    int w = e - j * wpr;
    for (int i = lane; i < pn; i += 32 * kFly) {
      W v[kFly];
#pragma unroll
      for (int u = 0; u < kFly; ++u) {
        v[u] = (e >= 0 && i + 32 * u < pn) ? src(j, w) : W();
        e += 32;
        j += jd;
        w += wd;
        if (w >= wpr) {
          w -= wpr;
          ++j;
        }
      }
#pragma unroll
      for (int u = 0; u < kFly; ++u)
        if (i + 32 * u < pn) tile[i + 32 * u] = v[u];
    }
    __syncwarp();
    for (int q = lane; q * kPer < pn; q += 32) {
      const int e0 = p0 + q * kPer;
      if (e0 >= 0 && e0 + kPer <= total) {
        *reinterpret_cast<uint4*>(dst + e0) = *reinterpret_cast<const uint4*>(tile + q * kPer);
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          if (e0 + i >= 0 && e0 + i < total) dst[e0 + i] = tile[q * kPer + i];
      }
    }
    __syncwarp();  // the tile is free again
  }
}

// Issue the loads of a run of 16-byte words that fits the tile (cp.async,
// 16 bytes a lane, into the tile); drain_run stores it later, so that the
// work the warp does in between (its next selection) overlaps them.
__device__ __forceinline__ void prefetch_run(const uint4* __restrict__ src, const int* slots,
                                             int k, int wpr, const Tile& t, int lane) {
  const uint32_t tile = hopper::smem_u32(t.base);
  const int jd = 32 / wpr;
  const int wd = 32 - jd * wpr;
  int j = lane / wpr;
  int w = lane - j * wpr;
  for (int e = lane; e < k * wpr; e += 32) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(tile + 16 * e),
                 "l"(src + static_cast<int64_t>(slots[j]) * wpr + w)
                 : "memory");
    j += jd;
    w += wd;
    if (w >= wpr) {
      w -= wpr;
      ++j;
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Store the run prefetch_run loaded (`words` 16-byte words) to dst.
__device__ __forceinline__ void drain_run(uint4* __restrict__ dst, int words, const Tile& t,
                                          int lane) {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
  const uint4* tile = reinterpret_cast<const uint4*>(t.base);
  for (int e = lane; e < words; e += 32) dst[e] = tile[e];
  __syncwarp();  // the tile is free again
}

// Word w of row j: the gathered row slots[j] of `wpr` words from `base`.
template <typename W>
struct GatheredRows {
  const W* base;
  const int* slots;
  int wpr;
  __device__ __forceinline__ W operator()(int j, int w) const {
    return base[static_cast<int64_t>(slots[j]) * wpr + w];
  }
};

// Coordinate w of row j: the point slots[j] staged as (x, y, z, pen).
struct StagedXyz {
  const float4* pts;
  const int* slots;
  __device__ __forceinline__ float operator()(int j, int w) const {
    const float4 p = pts[slots[j]];
    return w == 0 ? p.x : w == 1 ? p.y : p.z;
  }
};

// The feature rows of a run, `row_bytes` = words * word_bytes: bulk copies
// (`bulk`, word_bytes 16), else words of word_bytes (2, 4, 8 or 16).
__device__ __forceinline__ void move_feature_rows(void* dst, const void* src,
                                                  const int* slots, int k, int row_bytes,
                                                  int word_bytes, bool bulk, Tile& t,
                                                  int lane) {
  if (bulk) {
    move_bulk(static_cast<unsigned char*>(dst), static_cast<const unsigned char*>(src),
              slots, k, row_bytes, t, lane);
    return;
  }
  const int wpr = row_bytes / word_bytes;
  switch (word_bytes) {
    case 16:
      move_words(static_cast<uint4*>(dst),
                 GatheredRows<uint4>{static_cast<const uint4*>(src), slots, wpr}, k, wpr,
                 t, lane);
      break;
    case 8:
      move_words(static_cast<uint2*>(dst),
                 GatheredRows<uint2>{static_cast<const uint2*>(src), slots, wpr}, k, wpr,
                 t, lane);
      break;
    case 4:
      move_words(static_cast<uint32_t*>(dst),
                 GatheredRows<uint32_t>{static_cast<const uint32_t*>(src), slots, wpr}, k,
                 wpr, t, lane);
      break;
    default:
      move_words(static_cast<uint16_t*>(dst),
                 GatheredRows<uint16_t>{static_cast<const uint16_t*>(src), slots, wpr}, k,
                 wpr, t, lane);
      break;
  }
}

}  // namespace row_move
