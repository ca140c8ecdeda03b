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
// repeats it, as in the TPU kernel. Points order by the 64-bit key (distance
// bits, index): the TPU kernel's (least distance, lowest index) order, since
// distances are never negative.
//
// Bound on the card: bytes at every stage of the driven paths (the gathered
// rows, B*S*k*F elements, are the bulk of the traffic); the distance tests,
// 9 fp32 instructions each for every (centroid, point) pair, come next.
//
// Two routes, chosen by `ops.knn_group_plan` from the shape alone:
//   - list (k <= 64, the cloud staged in shared memory): a block of 16 warps
//     stages its cloud once as (x, y, z, pen), in rows of 32 points rotated
//     so that both ways the warp reads it are free of bank conflicts
//     (`staged_at`), and serves `per_block` of its centroids, a warp one at
//     a time (two or four at once, sharing each staged point, measured no
//     faster: the selection is not bound by shared-memory reads).
//     Each centroid keeps its best keys as a warp-held sorted list of
//     32 * kP keys (kP = 1 for k <= 32, 2 for k <= 64; lane l holds list
//     entries l and 32 + l), stored in shared memory. One pass over the
//     points takes each lane's least key and second least distance (lane l
//     holds points l, l + 32, ..., visited in index order: a compare, three
//     min/max and a select a point). The k-th least of those 64 distances,
//     T (`kth_of_64`: two bitonic sorts of 32 and a merge), has at least k
//     points at or below it, so the k nearest are among the points at
//     distance <= T, about k + 3 of them at the driven shapes. A lane whose
//     second least distance lies above T holds one of them at most, its
//     least key; the few other lanes (two or more such points) are
//     searched again, the warp sweeping each one's points together. The
//     points found are appended, by a ballot and a popcount prefix, to the
//     centroid's buffer of 32 * kP keys; a full buffer (and the last one)
//     is sorted by a warp bitonic network and merged into the list by one
//     bitonic merge (`flush`), so the list ends as the exact 32 * kP least
//     keys of those points, the k nearest first. Then count = the list's
//     first k keys below 0.5e9 (the valid points all enter the list when
//     there are fewer than k), rounds = max(1, min(k, count)), slot j <
//     rounds is key j's index and the rest repeat slot 0.
//   - rounds (k > 64, or a cloud past shared memory): the first version's
//     algorithm, one warp a centroid, 8 warps a block. Lane l owns the
//     contiguous chunk of c = ceil(N / 32) points from l * c (staged as four
//     arrays at a stride of c | 1 where they fit, else read from global
//     memory), finds its chunk's least key, and each of min(k, count) rounds
//     takes the warp-wide least key as the next slot and rescans only the
//     winner's chunk for its least key above the winner.
// The write (list route): a centroid's k feature rows leave as one
// contiguous run through the warp's tile (row_move.cuh), the way the plan's
// `rows` says: a run of 16-byte words that fits the tile is prefetched
// (cp.async) while the warp selects its next centroid, then stored from the
// tile; wider runs of rows of 256 bytes or more by 1-D bulk copies in and
// one bulk store a piece out; the rest as words of the widest size the
// alignment allows, in 16-byte stores. The xyz rows leave from the staged
// points the same way, idx by the lanes. The rounds route copies rows lane
// by lane as the first version did.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "row_move.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kPen = 1e9f;
constexpr float kValidBelow = 0.5e9f;
constexpr unsigned long long kNone = ~0ull;

// ---- the rounds route ----

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

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

// The rounds route (the first version): one warp a centroid, 8 warps a block.
template <bool kShared, typename T>
__global__ void __launch_bounds__(kThreads)
    knn_rounds_kernel(const float* __restrict__ xyz, const void* feats,
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
cudaError_t launch_rounds(const float* xyz, const void* feats, const float* cents,
                   const uint8_t* mask, int b, int n, int s_count, int k, int f,
                   int vec, int* idx, float* gx, void* gf, size_t smem,
                   int blocks_x, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_rounds_kernel<kShared, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(blocks_x, b);
  knn_rounds_kernel<kShared, T><<<grid, kThreads, smem, stream>>>(
      xyz, feats, cents, mask, n, s_count, k, f, vec, idx, gx, gf);
  return cudaGetLastError();
}


// ---- the list route ----

constexpr int kListWarps = 16;
constexpr int kListThreads = kListWarps * 32;
// how the feature rows leave (ops.knn_group_plan's `rows`; 0: words)
constexpr int kRowsBulk = 1;
constexpr int kRowsPrefetch = 2;

// Sort the warp's 32 * kP keys descending, element e = p * 32 + lane held as
// v[p] by lane `lane` (a bitonic network: a step between lanes j apart is a
// shuffle, the step between v[0] and v[1] stays in the lane).
template <int kP>
__device__ __forceinline__ void sort_desc(unsigned long long (&v)[kP], int lane) {
#pragma unroll
  for (int s = 2; s <= 32 * kP; s <<= 1) {
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1) {
      if (j >= 32) {  // kP == 2, s == 64: the one block, descending
        const unsigned long long a = v[0];
        const unsigned long long b = v[kP - 1];
        v[0] = a < b ? b : a;
        v[kP - 1] = a < b ? a : b;
      } else {
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const unsigned long long o = __shfl_xor_sync(kFull, v[p], j);
          // blocks of s ascend where bit s of e is set, so the last (all of
          // them) descends; the lower element of a pair keeps the minimum in
          // an ascending block
          const bool asc = ((p * 32 + lane) & s) != 0;
          const bool keep_min = ((lane & j) == 0) == asc;
          const bool take = keep_min ? (o < v[p]) : (v[p] < o);
          v[p] = take ? o : v[p];
        }
      }
    }
  }
}

// l (ascending) <- the 32 * kP least keys of l and v (descending), ascending.
template <int kP>
__device__ __forceinline__ void merge_asc(unsigned long long (&l)[kP],
                                          const unsigned long long (&v)[kP], int lane) {
#pragma unroll
  for (int p = 0; p < kP; ++p) l[p] = v[p] < l[p] ? v[p] : l[p];  // a bitonic sequence
#pragma unroll
  for (int j = 16 * kP; j > 0; j >>= 1) {
    if (j >= 32) {
      const unsigned long long a = l[0];
      const unsigned long long b = l[kP - 1];
      l[0] = a < b ? a : b;
      l[kP - 1] = a < b ? b : a;
    } else {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const unsigned long long o = __shfl_xor_sync(kFull, l[p], j);
        const bool lower = (lane & j) == 0;
        l[p] = lower ? (o < l[p] ? o : l[p]) : (l[p] < o ? o : l[p]);
      }
    }
  }
}

// Merge the `cnt` keys of `buf` into the sorted list `list` (both the warp's
// shared memory, 32 * kP keys each); into an empty list (`first`) the sorted
// buffer goes as it is, reversed.
template <int kP>
__device__ __noinline__ void flush(unsigned long long* list, const unsigned long long* buf,
                                   int cnt, bool first, int lane) {
  __syncwarp();  // every lane's appends are in the buffer
  unsigned long long v[kP];
  unsigned long long l[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int e = p * 32 + lane;
    v[p] = e < cnt ? buf[e] : kNone;
    l[p] = first ? kNone : list[e];
  }
  sort_desc<kP>(v, lane);
  if (first) {
#pragma unroll
    for (int p = 0; p < kP; ++p) l[p] = __shfl_sync(kFull, v[kP - 1 - p], 31 - lane);
  } else {
    merge_asc<kP>(l, v, lane);
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) list[p * 32 + lane] = l[p];
  __syncwarp();  // the buffer is read and the list written
}

// Where point i of the cloud is staged: rows of 32 points, row q's points
// rotated by q / 4, so that a warp reads conflict-free both 32 consecutive
// points (a batch of the pass) and 32 points of one lane, l + 32 q for q =
// 4 (x % 8) + x / 8 (+ 32 h) at warp lane x (a lane searched again): in
// either, the eight lanes of a quarter-warp meet eight different 16-byte
// bank groups. The pass's four batches of a round share one rotation.
__device__ __forceinline__ int staged_at(int i) {
  return (i & ~31) | ((i + (i >> 7)) & 31);
}

// The TPU kernel's penalised distance of the staged point p from centroid c.
template <bool kMasked>
__device__ __forceinline__ float staged_dist(const float (&c)[3], float4 p) {
  const float dx = __fsub_rn(c[0], p.x);
  const float dy = __fsub_rn(c[1], p.y);
  const float dz = __fsub_rn(c[2], p.z);
  float acc = kMasked ? __fadd_rn(p.w, __fmul_rn(dx, dx)) : __fmul_rn(dx, dx);
  acc = __fadd_rn(acc, __fmul_rn(dy, dy));
  return __fadd_rn(acc, __fmul_rn(dz, dz));
}

// The pass over the points: each lane's least key (m1, i1) and second least
// distance m2 of its points from centroid c (lane l holds points l, l + 32,
// ..., visited in index order, so a strict compare keeps the lowest index on
// ties); +inf where a lane has fewer points.
template <bool kMasked>
__device__ __forceinline__ void lane_least(const float4* pts, int n, const float (&c)[3],
                                           float& m1, int& i1, float& m2, int lane) {
  constexpr int kB = 4;  // batches of 32 points a round, their loads in flight
  m1 = m2 = __int_as_float(0x7f800000);
  i1 = 0;
  int base = 0;
  for (; base + 32 * kB <= n; base += 32 * kB) {  // base a multiple of 128
    const float4* row = pts + base + ((lane + (base >> 7)) & 31);
    float4 p[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) p[u] = row[32 * u];  // pts[staged_at(i)]
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const float d = staged_dist<kMasked>(c, p[u]);
      i1 = d < m1 ? base + 32 * u + lane : i1;
      m2 = fminf(m2, fmaxf(m1, d));
      m1 = fminf(m1, d);
    }
  }
  for (int i = base + lane; i < n; i += 32) {
    const float d = staged_dist<kMasked>(c, pts[staged_at(i)]);
    i1 = d < m1 ? i : i1;
    m2 = fminf(m2, fmaxf(m1, d));
    m1 = fminf(m1, d);
  }
}

// Bitonic sort of the warp's 32 values (one a lane), ascending or not.
__device__ __forceinline__ unsigned sort32(unsigned v, bool ascending, int lane) {
#pragma unroll
  for (int s = 2; s <= 32; s <<= 1) {
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1) {
      const unsigned o = __shfl_xor_sync(kFull, v, j);
      const bool asc = ((lane & s) == 0) == ascending;
      v = (((lane & j) == 0) == asc) ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// The k-th least (1 <= k <= 64, warp-uniform) of the warp's 64 values a and
// b (two a lane): the two halves sorted, one ascending and one descending,
// give the 32 least and the 32 largest as bitonic sequences; the one that
// holds the k-th is sorted and read.
__device__ __forceinline__ unsigned kth_of_64(unsigned a, unsigned b, int k, int lane) {
  a = sort32(a, true, lane);
  b = sort32(b, false, lane);
  unsigned v = k > 32 ? max(a, b) : min(a, b);
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const unsigned o = __shfl_xor_sync(kFull, v, j);
    v = (lane & j) == 0 ? min(v, o) : max(v, o);
  }
  return __shfl_sync(kFull, v, (k - 1) & 31);
}

// Append the keys (distance bits db, index i) of the lanes where `take`
// holds to the centroid's buffer, merging the buffer into the list first
// where they do not fit.
template <int kP>
__device__ __forceinline__ void append(bool take, unsigned db, int i,
                                       unsigned long long* list, unsigned long long* buf,
                                       int& cnt, bool& first, int lane) {
  const unsigned ball = __ballot_sync(kFull, take);
  if (ball == 0u) return;
  const int got = __popc(ball);
  if (cnt + got > 32 * kP) {
    flush<kP>(list, buf, cnt, first, lane);
    cnt = 0;
    first = false;
  }
  if (take)
    buf[cnt + __popc(ball & ((1u << lane) - 1u))] =
        (static_cast<unsigned long long>(db) << 32) | static_cast<unsigned>(i);
  cnt += got;
}

// The list route's selection for the warp's centroid c: on return `list`
// holds its 32 * kP least keys, ascending (kNone past the cloud). One pass
// takes each lane's least key and second least distance (lane_least); the
// k-th least of those 64 values, T, has at least k points at or below it, so
// the k nearest are among the points at distance <= T. A lane whose second
// least distance lies above T holds one such point at most, its least key;
// the others (about a sixth of the lanes at the driven shapes) are searched
// again, the warp sweeping four of them at once, 32 points of each a step.
// Those points enter the buffer, and the buffer the list (`flush`).
template <int kP, bool kMasked>
__device__ __forceinline__ void select_list(const float4* pts, int n, const float (&c)[3],
                                            int k, unsigned long long* list,
                                            unsigned long long* buf, int lane) {
  constexpr int kR = 4;  // lanes searched again at once
  float m1;
  float m2;
  int i1;
  lane_least<kMasked>(pts, n, c, m1, i1, m2, lane);
  const unsigned t = kth_of_64(__float_as_uint(m1), __float_as_uint(m2), k, lane);
  const bool again = __float_as_uint(m2) <= t;
  int cnt = 0;
  bool first = true;  // the list is empty
  append<kP>(!again && __float_as_uint(m1) <= t, __float_as_uint(m1), i1, list, buf, cnt,
             first, lane);
  // the lanes searched again, kR at once: lane l's points l + 32 q, 32 of
  // them a step, q = 32 h + 4 (lane % 8) + lane / 8 (each of its rows once,
  // conflict-free), the kR lanes' tests in flight together
  const int q_lane = 4 * (lane & 7) + (lane >> 3);
  for (unsigned lanes = __ballot_sync(kFull, again); lanes != 0u;) {
    int l[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      l[r] = lanes != 0u ? __ffs(lanes) - 1 : -1;
      lanes &= lanes - 1u;
    }
    for (int h = 0; 1024 * h < n; ++h) {
      unsigned db[kR];
      int i[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        i[r] = l[r] + 32 * (32 * h + q_lane);
        db[r] = l[r] >= 0 && i[r] < n
                    ? __float_as_uint(staged_dist<kMasked>(c, pts[staged_at(i[r])]))
                    : 0xffffffffu;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
        append<kP>(db[r] <= t, db[r], i[r], list, buf, cnt, first, lane);
    }
  }
  flush<kP>(list, buf, cnt, first, lane);  // at least one key: the least
}

// A centroid's slots from its final list: key j's index for j < rounds =
// max(1, min(k, count)), count the keys among the first k below 0.5e9; the
// rest repeat slot 0.
template <int kP>
__device__ __forceinline__ void list_slots(const unsigned long long* list, int* slots,
                                           int k, int lane) {
  const unsigned valid_bits = __float_as_uint(kValidBelow);
  unsigned long long key[kP];
  int count = 0;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int e = p * 32 + lane;
    key[p] = list[e];
    count += __popc(__ballot_sync(
        kFull, e < k && static_cast<unsigned>(key[p] >> 32) < valid_bits));
  }
  const int rounds = max(1, count);
  const int slot0 = static_cast<int>(__shfl_sync(kFull, static_cast<unsigned>(key[0]), 0));
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int e = p * 32 + lane;
    if (e < k) slots[e] = e < rounds ? static_cast<int>(static_cast<unsigned>(key[p])) : slot0;
  }
  __syncwarp();
}

// Coordinate w of row j: the point slots[j], staged at staged_at(slots[j]).
struct RotatedXyz {
  const float4* pts;
  const int* slots;
  __device__ __forceinline__ float operator()(int j, int w) const {
    const float4 p = pts[staged_at(slots[j])];
    return w == 0 ? p.x : w == 1 ? p.y : p.z;
  }
};

template <int kP, bool kMasked>
__global__ void __launch_bounds__(kListThreads, 2)
    knn_list_kernel(const float* __restrict__ xyz, const void* feats,
                    const float* __restrict__ cents, const uint8_t* __restrict__ mask,
                    int n, int s_count, int per_block, int k, int row_bytes,
                    int word_bytes, int rows, int tile_bytes, int* __restrict__ idx,
                    float* __restrict__ gx, void* gf) {
  // shared memory (ops.knn_group_plan's layout): each warp's mbarrier, then
  // each warp's list and buffer of 32 * kP keys, each warp's tile, the
  // staged points
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kCap = 32 * kP;
  constexpr int kBarBytes = kListWarps * 8;
  constexpr int kKeyBytes = kListWarps * 2 * kCap * 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp;
  unsigned long long* list =
      reinterpret_cast<unsigned long long*>(smem + kBarBytes) + warp * 2 * kCap;
  unsigned long long* buf = list + kCap;
  int* slots = reinterpret_cast<int*>(buf);  // the buffer, once spent
  unsigned char* tile = smem + kBarBytes + kKeyBytes + warp * tile_bytes;
  float4* pts =
      reinterpret_cast<float4*>(smem + kBarBytes + kKeyBytes + kListWarps * tile_bytes);

  const int64_t b = blockIdx.y;
  const float* xb = xyz + b * n * 3;
  const uint8_t* mb = kMasked ? mask + b * n : nullptr;
  for (int i = threadIdx.x; i < n; i += kListThreads) {
    const float pen = (!kMasked || mb[i] != 0) ? 0.f : kPen;
    pts[staged_at(i)] = make_float4(xb[3 * i], xb[3 * i + 1], xb[3 * i + 2], pen);
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
  uint4* pending = nullptr;  // a prefetched run not stored yet
  for (int s = blockIdx.x * per_block + warp; s < s_hi; s += kListWarps) {
    const int64_t row = b * s_count + s;
    const float c[3] = {cents[3 * row], cents[3 * row + 1], cents[3 * row + 2]};
    select_list<kP, kMasked>(pts, n, c, k, list, buf, lane);
    list_slots<kP>(list, slots, k, lane);
    for (int j = lane; j < k; j += 32) idx[row * k + j] = slots[j];
    if (gx != nullptr)
      row_move::move_words(gx + row * k * 3, RotatedXyz{pts, slots}, k, 3, t, lane);
    if (fb != nullptr) {
      unsigned char* dst = static_cast<unsigned char*>(gf) + row * k * row_bytes;
      if (rows == kRowsPrefetch) {  // store the last run, load this one
        if (pending != nullptr) row_move::drain_run(pending, k * row_bytes / 16, t, lane);
        row_move::prefetch_run(reinterpret_cast<const uint4*>(fb), slots, k, row_bytes / 16,
                               t, lane);
        pending = reinterpret_cast<uint4*>(dst);
      } else {
        row_move::move_feature_rows(dst, fb, slots, k, row_bytes, word_bytes,
                                    rows == kRowsBulk, t, lane);
      }
    }
    __syncwarp();  // the slots are read before the next centroid's buffer fills
  }
  if (pending != nullptr) row_move::drain_run(pending, k * row_bytes / 16, t, lane);
  row_move::tile_free(lane);
}

template <int kP, bool kMasked>
cudaError_t launch_list(const float* xyz, const void* feats, const float* cents,
                        const uint8_t* mask, int b, int n, int s_count, int per_block,
                        int k, int row_bytes, int word_bytes, int rows, int tile_bytes,
                        int* idx, float* gx, void* gf, int blocks, int smem,
                        cudaStream_t stream) {
  const cudaError_t err = hopper::allow_all_smem<knn_list_kernel<kP, kMasked>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, b);
  knn_list_kernel<kP, kMasked><<<grid, kListThreads, smem, stream>>>(
      xyz, feats, cents, mask, n, s_count, per_block, k, row_bytes, word_bytes, rows,
      tile_bytes, idx, gx, gf);
  return cudaGetLastError();
}

template <int kP>
cudaError_t launch_list_masked(const float* xyz, const void* feats, const float* cents,
                               const uint8_t* mask, int b, int n, int s_count,
                               int per_block, int k, int row_bytes, int word_bytes,
                               int rows, int tile_bytes, int* idx, float* gx, void* gf,
                               int blocks, int smem, cudaStream_t stream) {
  return mask != nullptr
             ? launch_list<kP, true>(xyz, feats, cents, mask, b, n, s_count, per_block, k,
                                     row_bytes, word_bytes, rows, tile_bytes, idx, gx, gf,
                                     blocks, smem, stream)
             : launch_list<kP, false>(xyz, feats, cents, mask, b, n, s_count, per_block, k,
                                      row_bytes, word_bytes, rows, tile_bytes, idx, gx, gf,
                                      blocks, smem, stream);
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// xyz (B, N, 3) f32, feats (B, N, F) of esize-byte elements (4: fp32, 2:
// bf16) or null with F = 0, cents (B, S, 3) f32, mask (B, N) bool or null;
// idx (B, S, k) i32, gx (B, S, k, 3) f32 or null, gf (B, S, k, F) like
// feats or null with F = 0. `word` is the widest word (2, 4, 8 or 16 bytes)
// that divides a feature row and both feature base addresses. The launch is
// `ops.knn_group_plan`'s: route 0 list, 1 rounds with the cloud in shared
// memory, 2 rounds from global memory; `keys` list keys a lane (list
// route); `per_block` centroids a block,
// `blocks` blocks a cloud, a warp's tile of `tile` bytes, the feature rows
// by `rows` (0 words, 1 bulk copies, 2 prefetched runs; list route), `smem`
// bytes of shared memory. Returns the CUDA
// error of the launch (0 on success), cudaErrorInvalidValue for a launch
// the plan cannot give; the caller checked the bounds.
extern "C" int knn_group_launch(const float* xyz, const void* feats, int esize,
                                const float* cents, const uint8_t* mask, int b, int n,
                                int s_count, int k, int f, int* idx, float* gx, void* gf,
                                int word, int route, int keys, int per_block, int blocks,
                                int tile, int rows, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (route == 0) {
    const int row_bytes = f * esize;
    const void* fp = f > 0 ? feats : nullptr;  // no rows without features
#define LIST_ARGS xyz, fp, cents, mask, b, n, s_count, per_block, k, row_bytes, word, rows, \
                  tile, idx, gx, gf, blocks, smem, st
    if (keys == 1) err = launch_list_masked<1>(LIST_ARGS);
    else if (keys == 2) err = launch_list_masked<2>(LIST_ARGS);
#undef LIST_ARGS
    return static_cast<int>(err);
  }
  const bool shared = route == 1;
  const int vec = f > 0 && word == 16;  // the first version's 16-byte copies
  if (esize == 2) {
    err = shared ? launch_rounds<true, uint16_t>(xyz, feats, cents, mask, b, n, s_count, k,
                                                 f, vec, idx, gx, gf, smem, blocks, st)
                 : launch_rounds<false, uint16_t>(xyz, feats, cents, mask, b, n, s_count,
                                                  k, f, vec, idx, gx, gf, 0, blocks, st);
  } else {
    err = shared ? launch_rounds<true, uint32_t>(xyz, feats, cents, mask, b, n, s_count, k,
                                                 f, vec, idx, gx, gf, smem, blocks, st)
                 : launch_rounds<false, uint32_t>(xyz, feats, cents, mask, b, n, s_count,
                                                  k, f, vec, idx, gx, gf, 0, blocks, st);
  }
  return static_cast<int>(err);
}
