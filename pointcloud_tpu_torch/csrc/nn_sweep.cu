// Bidirectional nearest-neighbour sweep for Chamfer distance (sm_90a).
//
// Replaces pointcloud_tpu/ops/pallas_kernels.py:_nn_kernel (reached through
// nearest_neighbor_pallas). For clouds x (B, N, C) and y (B, M, C), C <= 8,
// it writes, for every x point, the squared distance to its nearest valid
// y point and that point's index, and the same for every y point against x:
//   min_x (B, N) f32, amin_x (B, N) i32, min_y (B, M) f32, amin_y (B, M) i32.
// The (B, N, M) cost matrix never reaches device memory.
//
// Semantics (shared with the plain version, ops/nn_sweep.py):
//   * a masked target costs exactly 1e10 (the where(mask, d, BIG) of the
//     dense path), so a query with no valid target gets 1e10 and index 0;
//   * costs are clamped at 0 and targets taken in index order with a strict
//     `<`, so the FIRST minimal index wins ties, as torch.argmin over the
//     plain version's clamped costs does (bit-equal targets give bit-equal
//     costs; costs that round below 0 all tie at 0);
//   * the returned value is the direct fp32 sum over C of (q - t)^2 for the
//     chosen target (fmaf in dimension order), clamped at 0; a masked query
//     gets +1e10 on top of it (its index is still the nearest valid
//     target's).
//
// Design: the pair costs come from the tensor cores, the CUDA cores only
// reduce rows. Both clouds of a batch element are centred on a valid point
// (x's first valid point, else y's, else x's first point: the coordinates
// of a masked point never enter the error of a valid pair's cost); then
// each cost q.q + t.t - 2 q.t is ONE bf16 `wgmma` product of
// depth K = 6C + 6 (padded to a multiple of 16) with fp32 accumulation:
// every fp32 value is split three ways into bf16 (hi + mid + lo carries
// about 24 bits), the query side scaled by -2 (exact), and each dimension
// contributes the six significant cross products hi.hi, hi.mid, hi.lo,
// mid.hi, mid.mid, lo.hi; the norms enter as three more columns each
// against constant 1s. That is the TPU kernel's split-bf16 MXU cross term
// (two-way there) taken one level deeper, so that the cost is about as
// accurate as the plain version's fp32 expansion.
//   A block owns one direction of one batch element (blockIdx.z 0: x against
// y, 1: y against x) and a share of its query tiles (blockIdx.x of
// `splits`). The block's threads stage the target cloud's operand, up to
// `chunk` targets at a time, into shared memory once (K-major, unswizzled
// 8 x 16-byte core matrices); each of its four warpgroups then forms one
// 64-row query tile at a time and sweeps the resident targets 128 columns a
// product (wgmma m64n128k16, K / 16 steps). The epilogue keeps a running
// (min, index) per accumulator row in registers: a compare and two selects
// a pair on the raw cost (plus a select for a target mask). The clamp at 0
// costs no instruction a pair: a row's first tile whose minimum is <= 0 is
// searched again, from the accumulators still in registers, for its first
// column <= 0, and the row then settles (its minimum NaN, so that no
// later column replaces it); that tile is rare (a near-duplicate of the
// query) and the search warp-uniform. The test for it, a min, a compare
// and a vote a tile, costs about 2% at the eval shape. After the sweep the 4
// lanes of a row merge with the lowest index winning ties, and the chosen
// pair's value is recomputed by direct differences, so that the returned
// values are those of the direct formula; only a near-tie within the
// expansion's error can choose another index than direct differences.
// A cloud of more targets than one chunk keeps each query's (min, index)
// in the outputs between chunks. Padding targets carry a norm of 3.4e38
// and never win; a target mask selects exactly 1e10 in the epilogue (1e10
// folded into the norm would round, at an fp32 ulp of 1024).
//
// Accuracy: the three-way split drops products below 2^-22 of |q||t|; the
// fp32 accumulation of the tensor cores (not rounded to nearest at every
// add) adds a few ulps of the partial sums, which are of the order of the
// centred norms. chip_smoke.py measures the largest |expansion cost -
// direct cost| over the eval step's 512 x 2048 x 2048 pairs (C = 6) and
// logs it; PERF.md records it. The gates (tests/test_torch_cuda.py,
// chip_smoke.py) were checked on unit-cube clouds, on unit-cube clouds
// whose masked first x point lies 1e3 away, and on the paths' own
// normalised clouds. The error grows with the centred norms of the valid
// points, i.e. with a cloud's extent, not with its distance from the origin
// (a valid point is the centre); the plain version's fp32 expansion,
// uncentred, has the larger error there.
//
// Bound on the card: both directions form 2 B N M products of depth K,
// 2 K flops each, on the tensor cores (989 TFLOP/s bf16), and reduce
// every pair on the CUDA cores (compare, two selects: 3 operations at the
// fp32 rate, 67 TFLOP/s); bytes are negligible. At B=512, N=M=2048, C=6
// the products take 0.42 ms and the reductions 0.19 ms: the products
// bind. On the card (PERF.md) the kernel takes about the products' time
// plus the epilogue's: its three instructions a pair, which the card
// issues at about half its fp32 rate, do not overlap the products, not even
// those of other warpgroups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarpgroups = 4;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kRows = 64;    // query rows a warpgroup tile (wgmma M)
constexpr int kCols = 128;   // target columns a product (wgmma N)
constexpr float kBig = 1e10f;  // masked-point penalty (ops/geometry.py _BIG)
constexpr uint16_t kOne = 0x3F80;      // bf16 1.0
constexpr uint16_t kPadNorm = 0x7F7F;  // bf16 3.39e38: a padding target's norm
constexpr int kBadArgs = static_cast<int>(cudaErrorInvalidValue);

__host__ __device__ constexpr int depth(int c) { return (6 * c + 6 + 15) / 16 * 16; }

// Dynamic shared memory of a block, as the kernel lays it out: the target
// chunk, one query tile a warpgroup, the chunk's target-mask words, and
// 1024 bytes of slack for the alignment.
__host__ __device__ constexpr int smem_bytes(int c, int chunk) {
  return chunk * 2 * depth(c) + kWarpgroups * kRows * 2 * depth(c) + chunk / kCols * 16 +
         1024;
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v = hi + mid + lo, each rounded to bf16 in turn (the remainders are exact).
__device__ __forceinline__ void split3(float v, uint16_t& h, uint16_t& m, uint16_t& l) {
  h = bf16_bits(v);
  const float r1 = __fsub_rn(v, __bfloat162float(__ushort_as_bfloat16(h)));
  m = bf16_bits(r1);
  const float r2 = __fsub_rn(r1, __bfloat162float(__ushort_as_bfloat16(m)));
  l = bf16_bits(r2);
}

// The depth(C) bf16 operand values of one point, packed in pairs. A query
// (kQuery) row, per dimension c at 6c: -2 v split as [h, h, h, m, m, l],
// then [n2 h, n2 m, n2 l, 1, 1, 1]; a target row [h, m, l, h, m, h] of v,
// then [1, 1, 1, n2 h, n2 m, n2 l]; v = p - ref, n2 = |v|^2 in dimension
// order. p == nullptr: a padding row (zeros; a target's norm 3.4e38).
template <int C, bool kQuery>
__device__ __forceinline__ void form_row(const float* p, const float (&ref)[C],
                                         uint32_t (&w)[depth(C) / 2]) {
  constexpr int K = depth(C);
  uint16_t v[K];
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = 0;
  if (p != nullptr) {
    float n2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float d = __fsub_rn(p[c], ref[c]);
      n2 = __fadd_rn(n2, __fmul_rn(d, d));
      uint16_t h, m, l;
      if (kQuery) {
        split3(__fmul_rn(-2.f, d), h, m, l);
        v[6 * c] = h, v[6 * c + 1] = h, v[6 * c + 2] = h;
        v[6 * c + 3] = m, v[6 * c + 4] = m, v[6 * c + 5] = l;
      } else {
        split3(d, h, m, l);
        v[6 * c] = h, v[6 * c + 1] = m, v[6 * c + 2] = l;
        v[6 * c + 3] = h, v[6 * c + 4] = m, v[6 * c + 5] = h;
      }
    }
    uint16_t h, m, l;
    split3(n2, h, m, l);
    constexpr int o = 6 * C;
    if (kQuery) {
      v[o] = h, v[o + 1] = m, v[o + 2] = l;
      v[o + 3] = kOne, v[o + 4] = kOne, v[o + 5] = kOne;
    } else {
      v[o] = kOne, v[o + 1] = kOne, v[o + 2] = kOne;
      v[o + 3] = h, v[o + 4] = m, v[o + 5] = l;
    }
  } else if (!kQuery) {
    v[6 * C + 3] = kPadNorm;
  }
#pragma unroll
  for (int i = 0; i < K / 2; ++i) {
    w[i] = static_cast<uint32_t>(v[2 * i]) | (static_cast<uint32_t>(v[2 * i + 1]) << 16);
  }
}

// Stores 16-byte chunks kc = first, first + step, ... of row r of a K-major
// unswizzled tile: core matrix (r / 8, kc) at (r / 8) SBO + kc 128 bytes.
template <int K>
__device__ __forceinline__ void store_row(unsigned char* tile, int r, const uint32_t (&w)[K / 2],
                                          int first, int step) {
  constexpr int kSbo = K / 8 * 128;
  unsigned char* row = tile + (r >> 3) * kSbo + (r & 7) * 16;
#pragma unroll
  for (int kc = 0; kc < K / 8; ++kc) {
    if (kc % step == first) {
      *reinterpret_cast<uint4*>(row + kc * 128) =
          make_uint4(w[4 * kc], w[4 * kc + 1], w[4 * kc + 2], w[4 * kc + 3]);
    }
  }
}

__device__ __forceinline__ void take_lower(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The index of a cloud's first valid point (mask null: 0; none: n), found by
// the whole block a round of kThreads points at a time.
__device__ int first_valid(const uint8_t* mask, int n, int* s_first) {
  if (mask == nullptr) return 0;
  __syncthreads();  // an earlier call's readers are done with s_first
  if (threadIdx.x == 0) *s_first = n;
  __syncthreads();
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + static_cast<int>(threadIdx.x);
    const bool valid = i < n && mask[i];
    if (valid) atomicMin(s_first, i);
    if (__syncthreads_or(valid)) break;
  }
  return *s_first;
}

// A row's clamped minimum from an earlier chunk as the sweep keeps it: 0
// (a cost <= 0 taken) settles at NaN.
__device__ __forceinline__ float settled(float clamped) {
  return clamped > 0.f ? clamped : __int_as_float(0x7fffffff);
}

// One query row's result: the direct cost of its chosen target (1e10 if
// that target is masked, i.e. no target is valid), clamped, +1e10 if the
// query is masked.
template <int C>
__device__ __forceinline__ void finish_row(const float* q, const float* t,
                                           const uint8_t* q_mask, const uint8_t* t_mask,
                                           int row, int j, float* min_out, int* amin_out) {
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float diff = q[static_cast<int64_t>(row) * C + c] - t[static_cast<int64_t>(j) * C + c];
    d = fmaf(diff, diff, d);
  }
  if (t_mask != nullptr && !t_mask[j]) d = kBig;
  float v = fmaxf(d, 0.f);
  if (q_mask != nullptr && !q_mask[row]) v += kBig;
  min_out[row] = v;
  amin_out[row] = j;
}

// The sweep of one direction: queries q (nq, C) against targets t (nt, C)
// of one batch element (pointers offset to it), masks likewise or null.
// kDump: also write every raw expansion cost, before the clamp, to dump
// (nq, nt).
template <int C, bool kTargetMask, bool kDump>
__device__ __forceinline__ void sweep(const float* __restrict__ q, const float* __restrict__ t,
                                      const uint8_t* __restrict__ q_mask,
                                      const uint8_t* __restrict__ t_mask, int nq, int nt,
                                      const float (&ref)[C], int chunk, int splits,
                                      unsigned char* s_t, unsigned char* s_q,
                                      uint32_t* s_mask, float* __restrict__ min_out,
                                      int* __restrict__ amin_out, float* __restrict__ dump) {
  constexpr int K = depth(C);
  constexpr int kRowBytes = 2 * K;
  constexpr uint32_t kSbo = K / 8 * 128;
  const float kInf = __int_as_float(0x7f800000);
  // warp-uniform warpgroup index (a shuffle from lane 0), so that ptxas
  // sees every wgmma under uniform control flow
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);
  const int tl = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int n_qtiles = (nq + kRows - 1) / kRows;
  const int nchunks = (nt + chunk - 1) / chunk;
  unsigned char* q_tile = s_q + wg * kRows * kRowBytes;

  float acc[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;

  for (int ci = 0; ci < nchunks; ++ci) {
    const int cbase = ci * chunk;
    const int clen = min(chunk, nt - cbase);
    const int ntiles = (clen + kCols - 1) / kCols;
    if (ci > 0) __syncthreads();  // every warpgroup is done with the last chunk
    for (int j = threadIdx.x; j < ntiles * kCols; j += kThreads) {
      uint32_t w[K / 2];
      form_row<C, false>(j < clen ? t + static_cast<int64_t>(cbase + j) * C : nullptr, ref, w);
      store_row<K>(s_t, j, w, 0, 1);
    }
    if (kTargetMask) {
      // word (tile, quad): bit 2 jj + e of column 128 tile + 8 jj + 2 quad + e,
      // the columns the lanes of that quad hold in the accumulator
      for (int wi = threadIdx.x; wi < ntiles * 4; wi += kThreads) {
        const int col0 = (wi >> 2) * kCols + 2 * (wi & 3);
        uint32_t bits = 0;
        for (int b = 0; b < 32; ++b) {
          const int col = col0 + 8 * (b >> 1) + (b & 1);
          if (col < clen && t_mask[cbase + col]) bits |= 1u << b;
        }
        s_mask[wi] = bits;
      }
    }
    hopper::fence_proxy_async();  // the operand stores, before wgmma reads them
    __syncthreads();

    for (int qt = blockIdx.x * kWarpgroups + wg; qt < n_qtiles;
         qt += splits * kWarpgroups) {
      hopper::named_sync(1 + wg, 128);  // the last tile's products are done
      {
        const int r = tl >> 1;
        const int row = qt * kRows + r;
        uint32_t w[K / 2];
        form_row<C, true>(row < nq ? q + static_cast<int64_t>(row) * C : nullptr, ref, w);
        store_row<K>(q_tile, r, w, tl & 1, 2);
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);

      // rows r0 and r0 + 8 of the tile; columns 8 j + 2 (lane % 4) + e
      const int r0 = qt * kRows + 16 * ((tl >> 5) & 3) + (lane >> 2);
      const int r1 = r0 + 8;
      // the row's running minimum of raw costs; NaN once it has taken a
      // cost <= 0 (clamped, 0: no later column can beat it, and no cost
      // compares below NaN)
      float best0 = kInf, best1 = kInf;
      int idx0 = 0, idx1 = 0;
      if (ci > 0 && r0 < nq) {  // the earlier chunks' (min, index), kept in the outputs
        best0 = settled(min_out[r0]);
        idx0 = amin_out[r0];
      }
      if (ci > 0 && r1 < nq) {
        best1 = settled(min_out[r1]);
        idx1 = amin_out[r1];
      }
      for (int ct = 0; ct < ntiles; ++ct) {
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < K / 16; ++k) {
          hopper::wgmma_m64n128k16<0, 0>(
              acc, hopper::desc_interleave(q_tile + 256 * k, 128, kSbo),
              hopper::desc_interleave(s_t + ct * kCols * kRowBytes + 256 * k, 128, kSbo), k);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);

        uint32_t mw = 0;
        if (kTargetMask) mw = s_mask[ct * 4 + (lane & 3)];
        const int col0 = cbase + ct * kCols + 2 * (lane & 3);
        if (kDump) {
#pragma unroll
          for (int jj = 0; jj < kCols / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = col0 + 8 * jj + e;
              if (col < nt && r0 < nq) dump[static_cast<int64_t>(r0) * nt + col] = acc[4 * jj + e];
              if (col < nt && r1 < nq)
                dump[static_cast<int64_t>(r1) * nt + col] = acc[4 * jj + 2 + e];
            }
          }
        }
        int s0 = -1, s1 = -1;  // the tile's column of a new minimum, if any
#pragma unroll
        for (int jj = 0; jj < kCols / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float d0 = acc[4 * jj + e];
            float d1 = acc[4 * jj + 2 + e];
            if (kTargetMask) {
              const bool ok = (mw >> (2 * jj + e)) & 1u;
              d0 = ok ? d0 : kBig;
              d1 = ok ? d1 : kBig;
            }
            if (d0 < best0) {  // strict: the first minimal column wins
              best0 = d0;
              s0 = 8 * jj + e;
            }
            if (d1 < best1) {
              best1 = d1;
              s1 = 8 * jj + e;
            }
          }
        }
        // A row's first tile with a cost <= 0: clamped, every such cost is 0,
        // so the row takes the tile's first column with a cost <= 0 and
        // settles (NaN). Rare (a near-duplicate of the query), and
        // warp-uniform, so that ptxas keeps the products asynchronous.
        // (fminf takes the other operand of a NaN.)
        if (__any_sync(0xffffffffu, fminf(best0, best1) <= 0.f)) {
          const bool z0 = best0 <= 0.f, z1 = best1 <= 0.f;
          int f0 = 0, f1 = 0;
#pragma unroll
          for (int jj = kCols / 8 - 1; jj >= 0; --jj) {
#pragma unroll
            for (int e = 1; e >= 0; --e) {
              const bool ok = !kTargetMask || ((mw >> (2 * jj + e)) & 1u);
              if (ok && acc[4 * jj + e] <= 0.f) f0 = 8 * jj + e;
              if (ok && acc[4 * jj + 2 + e] <= 0.f) f1 = 8 * jj + e;
            }
          }
          if (z0) {
            s0 = f0;
            best0 = __int_as_float(0x7fffffff);
          }
          if (z1) {
            s1 = f1;
            best1 = __int_as_float(0x7fffffff);
          }
        }
        if (s0 >= 0) idx0 = col0 + s0;
        if (s1 >= 0) idx1 = col0 + s1;
      }
      // the 4 lanes of a row hold interleaved columns: merge the clamped
      // minima (a settled NaN is 0), lowest index on ties
      best0 = fmaxf(best0, 0.f);
      best1 = fmaxf(best1, 0.f);
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        take_lower(best0, idx0, __shfl_xor_sync(0xffffffffu, best0, off),
                   __shfl_xor_sync(0xffffffffu, idx0, off));
        take_lower(best1, idx1, __shfl_xor_sync(0xffffffffu, best1, off),
                   __shfl_xor_sync(0xffffffffu, idx1, off));
      }
      if ((lane & 3) == 0) {
        if (ci + 1 < nchunks) {
          if (r0 < nq) {
            min_out[r0] = best0;
            amin_out[r0] = idx0;
          }
          if (r1 < nq) {
            min_out[r1] = best1;
            amin_out[r1] = idx1;
          }
        } else {
          if (r0 < nq) finish_row<C>(q, t, q_mask, t_mask, r0, idx0, min_out, amin_out);
          if (r1 < nq) finish_row<C>(q, t, q_mask, t_mask, r1, idx1, min_out, amin_out);
        }
      }
    }
  }
}

template <int C, bool kDump>
__global__ void __launch_bounds__(kThreads, 1) nn_sweep_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const uint8_t* __restrict__ x_mask, const uint8_t* __restrict__ y_mask,
    float* __restrict__ min_x, int* __restrict__ amin_x, float* __restrict__ min_y,
    int* __restrict__ amin_y, int n, int m, int chunk, int splits, float* __restrict__ dump_x,
    float* __restrict__ dump_y) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_first;
  unsigned char* s_t = hopper::align1024(smem_raw);
  unsigned char* s_q = s_t + chunk * 2 * depth(C);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_q + kWarpgroups * kRows * 2 * depth(C));

  const bool x_side = blockIdx.z == 0;
  const int nq = x_side ? n : m;
  const int nt = x_side ? m : n;
  // blocks without a query tile (the shorter cloud's direction) leave
  // together, before any barrier
  if (static_cast<int>(blockIdx.x) * kWarpgroups * kRows >= nq) return;

  const int64_t b = blockIdx.y;
  const float* xb = x + b * n * C;
  const float* yb = y + b * m * C;
  const uint8_t* xm = x_mask != nullptr ? x_mask + b * n : nullptr;
  const uint8_t* ym = y_mask != nullptr ? y_mask + b * m : nullptr;
  // both directions centre on x's first valid point, else y's, else x[0]
  const float* centre = xb;
  const int fx = first_valid(xm, n, &s_first);
  if (fx < n) {
    centre = xb + static_cast<int64_t>(fx) * C;
  } else {
    const int fy = first_valid(ym, m, &s_first);
    if (fy < m) centre = yb + static_cast<int64_t>(fy) * C;
  }
  float ref[C];
#pragma unroll
  for (int c = 0; c < C; ++c) ref[c] = centre[c];
  const float* q = x_side ? xb : yb;
  const float* t = x_side ? yb : xb;
  const uint8_t* q_mask = x_side ? xm : ym;
  const uint8_t* t_mask = x_side ? ym : xm;
  float* min_out = (x_side ? min_x + b * n : min_y + b * m);
  int* amin_out = (x_side ? amin_x + b * n : amin_y + b * m);
  float* dump = nullptr;
  if (kDump) dump = x_side ? dump_x + b * n * m : dump_y + b * m * n;

  if constexpr (kDump) {  // the diagnostic takes no masks
    sweep<C, false, true>(q, t, nullptr, nullptr, nq, nt, ref, chunk, splits, s_t, s_q,
                          s_mask, min_out, amin_out, dump);
  } else if (t_mask != nullptr) {
    sweep<C, true, false>(q, t, q_mask, t_mask, nq, nt, ref, chunk, splits, s_t, s_q, s_mask,
                          min_out, amin_out, dump);
  } else {
    sweep<C, false, false>(q, t, q_mask, nullptr, nq, nt, ref, chunk, splits, s_t, s_q,
                           s_mask, min_out, amin_out, dump);
  }
}

template <int C, bool kDump>
cudaError_t launch(const float* x, const float* y, const uint8_t* x_mask,
                   const uint8_t* y_mask, float* min_x, int* amin_x, float* min_y,
                   int* amin_y, int b, int n, int m, int chunk, int splits, int smem,
                   float* dump_x, float* dump_y, cudaStream_t stream) {
  const cudaError_t err = hopper::allow_all_smem<nn_sweep_kernel<C, kDump>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(b), 2);
  nn_sweep_kernel<C, kDump><<<grid, kThreads, smem, stream>>>(
      x, y, x_mask, y_mask, min_x, amin_x, min_y, amin_y, n, m, chunk, splits, dump_x, dump_y);
  return cudaGetLastError();
}

bool bad_args(int b, int n, int m, int c, int chunk, int splits, int smem) {
  return c < 1 || c > 8 || b < 1 || b > 65535 || n < 1 || m < 1 || splits < 1 ||
         chunk < kCols || chunk % kCols != 0 || smem != smem_bytes(c, chunk) || smem > 232448;
}

}  // namespace

#define NN_SWEEP_CASES(CALL) \
  switch (c) {               \
    case 1:                  \
      return CALL(1);        \
    case 2:                  \
      return CALL(2);        \
    case 3:                  \
      return CALL(3);        \
    case 4:                  \
      return CALL(4);        \
    case 5:                  \
      return CALL(5);        \
    case 6:                  \
      return CALL(6);        \
    case 7:                  \
      return CALL(7);        \
    case 8:                  \
      return CALL(8);        \
    default:                 \
      return kBadArgs;       \
  }

// Plain C entry point for ctypes. Pointers are device pointers of contiguous
// tensors; masks are bool (one byte per point) or null. chunk (targets a
// block keeps in shared memory, a multiple of 128), splits (blocks a
// direction of a batch element) and smem (bytes) come from ops/nn_sweep.py
// nn_plan; smem must be the kernel's own layout of that chunk. Returns the
// CUDA error code of the launch (0 on success; cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int nn_sweep_launch(const float* x, const float* y, const uint8_t* x_mask,
                               const uint8_t* y_mask, float* min_x, int* amin_x,
                               float* min_y, int* amin_y, int b, int n, int m, int c,
                               int chunk, int splits, int smem, void* stream) {
  if (bad_args(b, n, m, c, chunk, splits, smem)) return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NN_SWEEP_CALL(C_)                                                                  \
  static_cast<int>(launch<C_, false>(x, y, x_mask, y_mask, min_x, amin_x, min_y, amin_y, b, \
                                     n, m, chunk, splits, smem, nullptr, nullptr, s))
  NN_SWEEP_CASES(NN_SWEEP_CALL)
#undef NN_SWEEP_CALL
}

// A diagnostic, not the main path: the same sweep without masks that also
// writes every pair's raw expansion cost, before the clamp, to dump_x
// (B, N, M) and dump_y (B, M, N) fp32 (chip_smoke.py measures the
// expansion's error with it). Arguments and return as nn_sweep_launch.
extern "C" int nn_sweep_costs_launch(const float* x, const float* y, float* min_x,
                                     int* amin_x, float* min_y, int* amin_y, int b, int n,
                                     int m, int c, int chunk, int splits, int smem,
                                     float* dump_x, float* dump_y, void* stream) {
  if (bad_args(b, n, m, c, chunk, splits, smem) || dump_x == nullptr || dump_y == nullptr)
    return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NN_SWEEP_CALL(C_)                                                                   \
  static_cast<int>(launch<C_, true>(x, y, nullptr, nullptr, min_x, amin_x, min_y, amin_y, b, \
                                    n, m, chunk, splits, smem, dump_x, dump_y, s))
  NN_SWEEP_CASES(NN_SWEEP_CALL)
#undef NN_SWEEP_CALL
}

#undef NN_SWEEP_CASES
